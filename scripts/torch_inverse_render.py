#!/usr/bin/env python3
"""Inverse rendering with the PyTorch/CUDA port, after
``scripts/inverse_render.py``: recover perturbed scene parameters from a
rendered target by gradient descent through the whole SPPM pass.

    python3 scripts/torch_inverse_render.py [--exp albedo|ctrl] [--steps 200]
        [--kernel box|epanechnikov] [--platform cpu] [--res R] [--out PATH]

Two experiments, as JAX's:

  * ``albedo``: ``cornell_diffuse`` at 128^2 (4 x 16384 photons, depth 13,
    atlas 16, hit-point factor 1.5); the diffuse albedo table is scaled by
    per-channel factors in [0.55, 1.45] and recovered with the same draws
    every step (common random numbers), through the lane deposit's
    differentiable backward (kernels #3 and #4; their plain twins on the
    CPU), the diffuse albedos clipped to [0, 1] after each step;
  * ``ctrl``: ``bezier_patch`` at 48^2 (2 x 8192 photons, depth 6, the
    light at (10, 18, 108), the camera at (8, 8, 128) looking at (16, 6.6,
    116)); the control points get Gaussian noise of ``--sigma`` and are
    recovered under a loss averaged over ``--n-avg`` renders with fresh
    draws a step, against a 32-render target.

The perturbations are the same ``np.random.default_rng(seed)`` draws as
JAX's.  Adam follows optax's ``cosine_decay_schedule(lr, steps,
alpha=0.02)`` (``diff.train.adam_cosine``).  On the card the Newton kernel
(#1) at 8 restarts solves the Bezier hits, as JAX's script runs its Pallas
kernel on the TPU; on the CPU the default solver does.  ``--kernel
epanechnikov`` takes the smooth deposit (``deposit_bruteforce_epa``, plain
autograd).  Writes ``docs/INVERSE_<EXP>[_EPA]_PORT.json`` (JAX's keys, with
the device, the card's name and power limit, both drop counters summed
over every render, and ``reduced``) and the side-by-side PNG target |
initial | recovered.  Exits 1 when the recovery misses JAX's criterion,
and 3, writing nothing, when a render dropped an eye ray or a deposit
(``utils.metrics.refuse_drops``).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raytrace3_tpu_torch.core.device import record_fields, resolve_device  # noqa: E402

EXPERIMENTS = {
    "albedo": dict(cfg=dict(scene="cornell_diffuse", width=128, height=128, rounds=4,
                            photons_per_round=16384, max_depth=13, atlas_res=16,
                            hitpoint_factor=1.5),
                   pose=None, light=None, lr=2e-2, key="diff", n_avg=1),
    "ctrl": dict(cfg=dict(scene="bezier_patch", width=48, height=48, rounds=2,
                          photons_per_round=8192, max_depth=6, atlas_res=16,
                          bezier_compact_frac=1.0),
                 pose=((8.0, 8.0, 128.0), (16.0, 6.6, 116.0)),
                 light=[[10.0, 18.0, 108.0]], lr=1e-3, key="ctrl", n_avg=8),
}
#: The lane deposit's bounds take the reference camera as an extra point.
CAMERA = [50.0, 35.0, 230.0]
ALPHA = 0.02
DEFAULT_STEPS = 200
TARGET_RENDERS = 32
#: The averaged loss's generator seeds: step i's j-th render draws from
#: key * SEED_STRIDE + 1 + i * n_avg + j, the target's j-th from
#: key * SEED_STRIDE - 1 - j.
SEED_STRIDE = 1 << 24


def setup(exp: str, device, res: int | None = None, kernel: str = "box",
          photons: int | None = None):
    """(cfg, scene, render(params, gen) -> (image, stats)) of an experiment;
    ``res`` and ``photons`` (a round) cut it."""
    from raytrace3_tpu_torch.diff.train import make_render_fn
    from raytrace3_tpu_torch.ops.deposit_kernel import world_bounds_from_scene
    from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.deposit import deposit_bruteforce_epa
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    e = EXPERIMENTS[exp]
    cfg = RenderConfig(**e["cfg"])
    if res:
        cfg = cfg.replace(width=res, height=res)
    if photons:
        cfg = cfg.replace(photons_per_round=photons)
    scene = build_scene(cfg, device)
    if e["light"] is not None:
        scene = scene.replace(light_pos=torch.tensor(e["light"], dtype=torch.float32,
                                                     device=device))
    newton_fn = make_newton(cfg.newton_iters, 8) if device.type == "cuda" else None
    if kernel == "epanechnikov":
        deposit_fn = deposit_bruteforce_epa
    else:
        deposit_fn = DepositLane(tile=256, chunk=512, work_cap=16384, differentiable=True,
                                 **world_bounds_from_scene(scene, extra_points=[CAMERA]))
    render = make_render_fn(scene, cfg, camera_pose=e["pose"], newton_fn=newton_fn,
                            deposit_fn=deposit_fn, with_drops=True)
    return cfg, scene, render


def perturb(exp: str, true: dict, rng, sigma: float) -> dict:
    """JAX's perturbation of the experiment's parameter (the same draws)."""
    if exp == "albedo":
        t = true["diff"].cpu().numpy()
        fac = rng.uniform(0.55, 1.45, t.shape).astype(np.float32)
        return dict(true, diff=torch.as_tensor(np.clip(t * fac, 0.0, 1.0),
                                               device=true["diff"].device))
    t = true["ctrl"].cpu().numpy()
    noise = rng.normal(0.0, sigma, t.shape).astype(np.float32)
    return dict(true, ctrl=torch.as_tensor(t + noise, device=true["ctrl"].device))


def surface_fn(true_ctrl: torch.Tensor):
    """The mean distance between the recovered and the true patch surfaces
    on a 24 x 24 (u, v) grid."""
    from raytrace3_tpu_torch.geometry.bezier import bernstein

    bv = bernstein(torch.linspace(0.0, 1.0, 24, device=true_ctrl.device))
    surf = lambda c: torch.einsum("ia,jb,pabc->pijc", bv, bv, c)
    s_true = surf(true_ctrl)
    return lambda c: float(torch.sqrt(((surf(c) - s_true) ** 2).sum(-1)).mean())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", choices=sorted(EXPERIMENTS), default="albedo")
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", choices=["box", "epanechnikov"], default="box")
    ap.add_argument("--n-avg", type=int, default=0,
                    help="renders averaged a step (0 = the experiment's)")
    ap.add_argument("--sigma", type=float, default=0.05, help="ctrl perturbation stddev")
    ap.add_argument("--lr", type=float, default=0.0, help="0 = the experiment's")
    ap.add_argument("--res", type=int, default=None, help="cut the canvas (a CPU check)")
    ap.add_argument("--photons", type=int, default=None,
                    help="cut the photons a round (a CPU check)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--png", default=None)
    return ap


def recover(args, device) -> tuple[dict, list]:
    """Run the experiment of the parsed ``args`` on ``device``: (the record,
    the images target | initial | recovered, each (H*W, 3))."""
    from raytrace3_tpu_torch.diff.train import adam_cosine, extract_params

    e = EXPERIMENTS[args.exp]
    cfg, scene, render = setup(args.exp, device, args.res, args.kernel, args.photons)
    key_name = e["key"]
    lr = args.lr if args.lr > 0 else e["lr"]
    n_avg = args.n_avg or e["n_avg"]
    rng = np.random.default_rng(args.seed)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    key = args.seed + 1
    drops = {"dropped": 0, "deposits_dropped": 0}        # summed over every render

    def render_mean(p, seeds):
        acc = 0.0
        for s in seeds:
            img, stats = render(p, gen(s))
            for k in drops:
                drops[k] += int(stats[k])
            acc = acc + img
        return acc / len(seeds)

    # The step's seeds: the fixed key (common random numbers), or n_avg
    # fresh seeds a step for the averaged loss.
    step_seeds = (lambda i: [key]) if n_avg == 1 else (
        lambda i: [key * SEED_STRIDE + 1 + i * n_avg + j for j in range(n_avg)])
    true = extract_params(scene)
    print(f"inverse[{args.exp}]: rendering target ({cfg.width}^2, {device.type})...",
          file=sys.stderr, flush=True)
    with torch.no_grad():
        target = render_mean(true, [key] if n_avg == 1 else
                             [key * SEED_STRIDE - 1 - j for j in range(TARGET_RENDERS)])

    params = perturb(args.exp, true, rng, args.sigma)
    p_init = {k: v.clone() for k, v in params.items()}
    loss_fn = lambda p, seeds: ((render_mean(p, seeds) - target) ** 2).mean()

    # Identifiable coordinates: a nonzero gradient at the start.
    leaf = {k: v.clone().requires_grad_(k == key_name) for k, v in params.items()}
    loss_fn(leaf, [key]).backward()
    ident = (leaf[key_name].grad.abs() > 0).cpu().numpy()
    n_ident = int(ident.sum())

    def param_err(p):
        d = (p[key_name] - true[key_name]).abs().cpu().numpy()
        return float(d.mean()), float(d[ident].mean())

    _, p0_err_id = param_err(params)
    p0_err = param_err(params)[0]
    surface = surface_fn(true["ctrl"]) if key_name == "ctrl" else None
    s0_err = surface(params["ctrl"]) if surface else None

    params = {k: v.clone().requires_grad_(k == key_name) for k, v in params.items()}
    opt, sched = adam_cosine([params[key_name]], lr, args.steps, ALPHA)
    losses, errs = [], []
    t0 = time.time()
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, step_seeds(i))
        loss.backward()
        opt.step()
        sched.step()
        if args.exp == "albedo":
            with torch.no_grad():
                params["diff"].clamp_(0.0, 1.0)
        if i % 5 == 0 or i == args.steps - 1:
            loss = float(loss.detach())
            with torch.no_grad():
                err, err_id = param_err(params)
                se = surface(params["ctrl"]) if surface else -1.0
            losses.append([i, loss])
            errs.append([i, err, err_id, se])
            print(f"inverse[{args.exp}] step {i}: loss {loss:.3e} |d{key_name}| {err:.4f} "
                  f"(identifiable {err_id:.4f}" + (f", surface {se:.4f})" if surface else ")"),
                  file=sys.stderr, flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    final_err, final_err_id, final_s_err = errs[-1][1], errs[-1][2], errs[-1][3]
    reduced = []
    if args.res:
        reduced.append(f"canvas {e['cfg']['width']}^2 -> {args.res}^2")
    if args.photons:
        reduced.append(f"photons a round {e['cfg']['photons_per_round']} -> {args.photons}")
    if args.steps < DEFAULT_STEPS:
        reduced.append(f"steps {DEFAULT_STEPS} -> {args.steps}")
    if n_avg < e["n_avg"]:
        reduced.append(f"renders averaged a step {e['n_avg']} -> {n_avg}")
    record = {
        "experiment": args.exp, "scene": cfg.scene, "res": cfg.width,
        "photons_per_step": cfg.rounds * cfg.photons_per_round * n_avg,
        "steps": args.steps, "backend": device.type,
        "deposit_backend": ("bruteforce(epanechnikov, plain autograd)"
                            if args.kernel == "epanechnikov" else
                            "DepositLane(differentiable)"),
        "newton": "kernel #1, 8 restarts" if device.type == "cuda" else "solve_winner",
        "deposit_kernel": args.kernel, "n_avg": n_avg, "sigma": args.sigma, "lr": lr,
        "identifiable_coords": n_ident, "total_coords": int(ident.size),
        "initial_param_err": round(p0_err, 5), "final_param_err": round(final_err, 5),
        "initial_param_err_identifiable": round(p0_err_id, 5),
        "final_param_err_identifiable": round(final_err_id, 5),
        "err_reduction_identifiable": round(p0_err_id / max(final_err_id, 1e-9), 2),
        "initial_loss": losses[0][1], "final_loss": losses[-1][1],
        "loss_reduction": round(losses[0][1] / max(losses[-1][1], 1e-30), 1),
        "seconds": round(dt, 1), "step_seconds_mean": round(dt / args.steps, 3),
        "loss_curve": [[i, round(v, 8)] for i, v in losses],
        "param_err_curve": [[i, round(a, 6), round(b, 6), round(c, 6)]
                            for i, a, b, c in errs],
        "pass": bool((final_s_err < 0.25 * s0_err) if surface
                     else (final_err_id < 0.25 * p0_err_id)),
    }
    if surface:
        record.update(initial_surface_err=round(s0_err, 5),
                      final_surface_err=round(final_s_err, 5),
                      surface_err_reduction=round(s0_err / max(final_s_err, 1e-9), 2))

    # Side by side: target | initial | recovered.
    with torch.no_grad():
        imgs = [target, render_mean(p_init, [key]),
                render_mean({k: v.detach() for k, v in params.items()}, [key])]
    record.update(eye_dropped_total=drops["dropped"],
                  deposits_dropped_total=drops["deposits_dropped"],
                  **record_fields(device), reduced=reduced)
    return record, imgs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)
    from raytrace3_tpu_torch.render.sppm import tonemap
    from raytrace3_tpu_torch.utils.image import save_png
    from raytrace3_tpu_torch.utils.metrics import refuse_drops

    record, imgs = recover(args, device)
    refuse_drops({"dropped": record["eye_dropped_total"],
                  "deposits_dropped": record["deposits_dropped_total"]},
                 f"inverse rendering ({args.exp}, {args.kernel}) over {args.steps} steps")
    suffix = "_EPA" if args.kernel == "epanechnikov" else ""
    out = args.out or os.path.join(REPO, "docs", f"INVERSE_{args.exp.upper()}{suffix}_PORT.json")
    png = args.png or os.path.join(REPO, "docs", f"inverse_{args.exp}{suffix.lower()}_port.png")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    h = record["res"]
    trip = torch.cat([x.reshape(h, -1, 3) for x in imgs], 1)
    save_png(png, tonemap(trip).cpu().numpy(), tonemapped=True)
    print(json.dumps({k: v for k, v in record.items() if "curve" not in k}, indent=2))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
