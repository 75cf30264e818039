#!/usr/bin/env python3
"""Control-point recovery with the smooth deposit and a kernel-radius
anneal, on the PyTorch/CUDA port, after ``scripts/inverse_ctrl_anneal.py``.

    python3 scripts/torch_inverse_ctrl_anneal.py [--stages 32,8,2]
        [--steps-per-stage 150] [--platform cpu] [--res R] [--out PATH]

The ``ctrl`` experiment's scene (``bezier_patch`` at 48^2, 2 x 8192 photons,
depth 6, the light at (10, 18, 108), the camera at (8, 8, 128) looking at
(16, 6.6, 116)), its control points perturbed by Gaussian noise of
``--sigma`` from ``np.random.default_rng(seed)`` (JAX's draws), recovered
through the Epanechnikov bruteforce deposit (``deposit_bruteforce_epa``,
plain autograd) with common random numbers (one generator seed for target
and loss) in stages of decreasing ``init_r2``: each stage re-renders the
target at its radius and runs Adam under a cosine decay to 0.05 of
``--lr``.  On the card the Newton kernel (#1) at 8 restarts solves the
Bezier hits; on the CPU the default solver does.  Writes
``docs/INVERSE_CTRL_ANNEAL_PORT.json`` (JAX's keys, with the device, the
card's name and power limit, both drop counters summed over every render,
and ``reduced``) and ``docs/inverse_ctrl_anneal_port.png`` (target |
initial | recovered at the last radius).  Exits 1 when the recovery misses
JAX's criterion, and 3, writing nothing, when a render dropped an eye ray
or a deposit (``utils.metrics.refuse_drops``).  Imports no JAX.
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

CFG = dict(scene="bezier_patch", width=48, height=48, rounds=2, photons_per_round=8192,
           max_depth=6, atlas_res=16, bezier_compact_frac=1.0)
LIGHT = [[10.0, 18.0, 108.0]]
POSE = ((8.0, 8.0, 128.0), (16.0, 6.6, 116.0))
ALPHA = 0.05
DEFAULTS = dict(stages="32,8,2", steps_per_stage=150, sigma=0.05, lr=2e-3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default=DEFAULTS["stages"],
                    help="comma list of init_r2 values, coarse to fine")
    ap.add_argument("--steps-per-stage", type=int, default=DEFAULTS["steps_per_stage"])
    ap.add_argument("--sigma", type=float, default=DEFAULTS["sigma"])
    ap.add_argument("--lr", type=float, default=DEFAULTS["lr"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--res", type=int, default=None, help="cut the canvas (a CPU check)")
    ap.add_argument("--photons", type=int, default=None,
                    help="cut the photons a round (a CPU check)")
    ap.add_argument("--out", default=os.path.join(REPO, "docs",
                                                  "INVERSE_CTRL_ANNEAL_PORT.json"))
    ap.add_argument("--png", default=os.path.join(REPO, "docs",
                                                  "inverse_ctrl_anneal_port.png"))
    args = ap.parse_args(argv)

    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)
    from raytrace3_tpu_torch.diff.train import adam_cosine, extract_params, make_render_fn
    from raytrace3_tpu_torch.geometry.bezier import bernstein
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.deposit import deposit_bruteforce_epa
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.sppm import tonemap
    from raytrace3_tpu_torch.utils.config import RenderConfig
    from raytrace3_tpu_torch.utils.image import save_png
    from raytrace3_tpu_torch.utils.metrics import refuse_drops

    base_cfg = RenderConfig(**CFG)
    if args.res:
        base_cfg = base_cfg.replace(width=args.res, height=args.res)
    if args.photons:
        base_cfg = base_cfg.replace(photons_per_round=args.photons)
    scene = build_scene(base_cfg, device)
    scene = scene.replace(light_pos=torch.tensor(LIGHT, dtype=torch.float32, device=device))
    newton_fn = make_newton(base_cfg.newton_iters, 8) if device.type == "cuda" else None
    rng = np.random.default_rng(args.seed)
    true = extract_params(scene)
    key = args.seed + 1
    gen = lambda: torch.Generator(device=device).manual_seed(key)
    noise = torch.as_tensor(rng.normal(0.0, args.sigma, tuple(true["ctrl"].shape))
                            .astype(np.float32), device=device)
    params = dict(true, ctrl=true["ctrl"] + noise)
    drops = {"dropped": 0, "deposits_dropped": 0}

    bv = bernstein(torch.linspace(0.0, 1.0, 24, device=device))
    surf = lambda c: torch.einsum("ia,jb,pabc->pijc", bv, bv, c)
    s_true = surf(true["ctrl"])
    surface_err = lambda c: float(torch.sqrt(((surf(c) - s_true) ** 2).sum(-1)).mean())
    param_err = lambda c: float((c - true["ctrl"]).abs().mean())

    def make_render(r2):
        render = make_render_fn(scene, base_cfg.replace(init_r2=r2), camera_pose=POSE,
                                newton_fn=newton_fn, deposit_fn=deposit_bruteforce_epa,
                                with_drops=True)

        def run(p):
            img, stats = render(p, gen())
            for k in drops:
                drops[k] += int(stats[k])
            return img
        return run

    s0, p0 = surface_err(params["ctrl"]), param_err(params["ctrl"])
    stages = [float(s) for s in args.stages.split(",")]
    curves = []
    ctrl = params["ctrl"].clone().requires_grad_(True)
    t0 = time.time()
    for r2 in stages:
        render = make_render(r2)
        with torch.no_grad():
            target = render(true)
        opt, sched = adam_cosine([ctrl], args.lr, args.steps_per_stage, ALPHA)
        for i in range(args.steps_per_stage):
            opt.zero_grad(set_to_none=True)
            loss = ((render(dict(params, ctrl=ctrl)) - target) ** 2).mean()
            loss.backward()
            opt.step()
            sched.step()
            if i % 10 == 0 or i == args.steps_per_stage - 1:
                with torch.no_grad():
                    se, pe = surface_err(ctrl), param_err(ctrl)
                curves.append([r2, i, float(loss.detach()), pe, se])
                print(f"anneal r2={r2} step {i}: loss {curves[-1][2]:.3e} |dctrl| {pe:.4f} "
                      f"surface {se:.4f}", file=sys.stderr, flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    with torch.no_grad():
        sf, pf = surface_err(ctrl), param_err(ctrl)
        render = make_render(stages[-1])
        imgs = [render(true), render(params), render(dict(params, ctrl=ctrl.detach()))]
    refuse_drops(drops, f"the anneal over stages {args.stages}")
    reduced = [f"{k.replace('_', '-')} {v} -> {getattr(args, k)}" for k, v in DEFAULTS.items()
               if getattr(args, k) != v]
    if args.res:
        reduced.append(f"canvas {CFG['width']}^2 -> {args.res}^2")
    if args.photons:
        reduced.append(f"photons a round {CFG['photons_per_round']} -> {args.photons}")
    record = {
        "experiment": "ctrl (smooth kernel + radius anneal)",
        "deposit_kernel": "epanechnikov", "crn": True, "stages_init_r2": stages,
        "steps_per_stage": args.steps_per_stage, "sigma": args.sigma, "lr": args.lr,
        "backend": device.type,
        "newton": "kernel #1, 8 restarts" if device.type == "cuda" else "solve_winner",
        "initial_param_err": round(p0, 5), "final_param_err": round(pf, 5),
        "initial_surface_err": round(s0, 5), "final_surface_err": round(sf, 5),
        "surface_err_reduction": round(s0 / max(sf, 1e-9), 2),
        "seconds": round(dt, 1),
        "step_seconds_mean": round(dt / (len(stages) * args.steps_per_stage), 3),
        "curve": [[r2, i, round(v, 8), round(pe, 6), round(se, 6)]
                  for r2, i, v, pe, se in curves],
        "pass": bool(sf < 0.25 * s0),
        "eye_dropped_total": drops["dropped"], "deposits_dropped_total": drops["deposits_dropped"],
        **record_fields(device), "reduced": reduced,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    h = base_cfg.height
    save_png(args.png, tonemap(torch.cat([x.reshape(h, -1, 3) for x in imgs], 1)).cpu().numpy(),
             tonemapped=True)
    print(json.dumps({k: v for k, v in record.items() if k != "curve"}, indent=2))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
