#!/usr/bin/env python3
"""Newton restart study of the PyTorch/CUDA port, after
``scripts/newton_restart_study.py``.

    python3 scripts/torch_newton_restart_study.py [--platform cpu] [--n 262144]
        [--res 512] [--out docs/NEWTON_RESTARTS_PORT.json]

The port's Newton solve (``ops/newton_kernel.make_newton``: kernel #1 on the
card, its plain twin on the CPU) runs a stratified grid of restarts per
(ray, patch).  This study measures per-ray root agreement at restarts
{4, 8, 16, 32} against a 64-restart oracle on the JAX study's three ray
populations, drawn from the same ``np.random.default_rng(0)``:

  * eye:     the reference pose's camera rays at ``--res`` squared;
  * photon:  rays from the light sphere aimed at random points of the
             teapot's box (what the photon walk's box gate lets through);
  * grazing: distant origins aimed at random surface points plus an
             offset of about a patch (silhouettes and multiple roots).

Per (population, restarts): of the oracle's hits, the share the candidate
misses (miss), the share where both hit but t differs by more than 1e-3
relative (root_diff), and the candidate's hits the oracle does not find
(false_hit).  Writes the JSON record JAX's study writes, with the device,
the card's name and power limit, and ``reduced`` (every cut from JAX's
defaults).  Imports no JAX.
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

ORACLE = 64
CANDIDATES = (4, 8, 16, 32)
ITERS = 10
#: JAX's defaults: rays of the photon and grazing populations, the eye
#: population's canvas.
N_RAYS = 262144
RES = 512
#: The reference pose (Camera.h:32-54) and the light the photon
#: population leaves from.
BASE = np.array([50.0, 35.0, 230.0])
LOOK = BASE + np.array([0.0, 0.042612, -1.0])
LIGHT = np.array([50.0, 70.0, 110.0])


def study_ctrl(device) -> torch.Tensor:
    """The ``full`` scene's teapot control points, (32, 4, 4, 3)."""
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(scene="full", width=RES, height=RES, atlas_res=16)
    return build_scene(cfg, device).bezier.ctrl


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def populations(ctrl: torch.Tensor, n: int = N_RAYS, res: int = RES) -> dict:
    """{name: (org, dir)}, float32 numpy, the JAX study's draws in its order."""
    from raytrace3_tpu_torch.geometry.bezier import bernstein
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at

    rng = np.random.default_rng(0)
    c = ctrl.detach().cpu()
    bv = bernstein(torch.linspace(0.02, 0.98, 8))                   # (8, 4)
    surf = torch.einsum("ia,jb,pabc->pijc", bv, bv, c).numpy().reshape(-1, 3)
    flat = c.numpy().reshape(-1, 3)
    lo, hi = flat.min(0), flat.max(0)
    center, half = (lo + hi) / 2, (hi - lo) / 2

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    org_eye, dir_eye = (a.numpy() for a in emit_rays(look_at(f32(BASE), f32(LOOK), res, res)))

    o2 = LIGHT + rng.normal(size=(n, 3)) * 2.0
    tgt = center + rng.uniform(-1, 1, (n, 3)) * half
    d2 = tgt - o2
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)

    sp = surf[rng.integers(0, surf.shape[0], n)]
    o3 = center + rng.normal(size=(n, 3)) * 1.0
    o3 += (rng.uniform(size=(n, 1)) * 60 + 30) * _unit(rng, n)
    off = rng.normal(size=(n, 3)) * np.array([3.0, 1.0, 3.0])
    d3 = (sp + off) - o3
    d3 /= np.linalg.norm(d3, axis=1, keepdims=True)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return {"eye": (f(org_eye), f(dir_eye)), "photon": (f(o2), f(d2)),
            "grazing": (f(o3), f(d3))}


def score(t64, h64, t, h) -> dict:
    """A candidate's row against the oracle's roots (numpy arrays)."""
    both = h64 & h
    miss = h64 & ~h
    false_hit = h & ~h64
    tdiff = np.zeros_like(t64)
    tdiff[both] = np.abs(t[both] - t64[both]) / np.maximum(t64[both], 1e-6)
    root_diff = both & (tdiff > 1e-3)
    oh = max(int(h64.sum()), 1)
    return {"miss": int(miss.sum()), "miss_rate": float(miss.sum() / oh),
            "root_diff": int(root_diff.sum()), "root_diff_rate": float(root_diff.sum() / oh),
            "false_hit": int(false_hit.sum()),
            "max_tdiff_rel": float(tdiff.max()) if both.any() else 0.0}


def solve_rays(org, dir, ctrl, restarts: int, chunk: int = 0):
    """(t, hit) numpy of ``make_newton(ITERS, restarts)`` on the rays, in
    chunks of ``chunk`` rays (0: one call).  Each ray's root depends on that
    ray alone, so the chunks change no bit.  On the CPU only the rays that
    open some patch's box go to the plain twin: the others accept no root
    by the solve's own gate and read (BIG, miss)."""
    from raytrace3_tpu_torch.ops.newton_kernel import BIG, make_newton, open_pairs

    solve = make_newton(ITERS, restarts)
    dev = ctrl.device
    org, dir = torch.as_tensor(org), torch.as_tensor(dir)
    t_all = torch.full((org.shape[0],), BIG, dtype=torch.float32)
    hit_all = torch.zeros((org.shape[0],), dtype=torch.bool)
    rows = torch.arange(org.shape[0])
    if dev.type != "cuda":
        rows = rows[open_pairs(org, dir, ctrl.cpu()).any(1)]
    step = chunk or max(len(rows), 1)
    for i in range(0, len(rows), step):
        idx = rows[i:i + step]
        t, _, _, _, hit = solve(org[idx].to(dev), dir[idx].to(dev), ctrl)
        t_all[idx], hit_all[idx] = t.cpu(), hit.cpu()
    return t_all.numpy(), hit_all.numpy()


def study(pops: dict, ctrl, candidates=CANDIDATES, oracle: int = ORACLE,
          chunk: int = 0) -> dict:
    """{population: {"oracle_hits", str(r): score row}} and the seconds
    each restart count took over all populations."""
    rows, seconds = {}, {}
    for name, (o, d) in pops.items():
        t64, h64 = solve_rays(o, d, ctrl, oracle, chunk)
        row = {"oracle_hits": int(h64.sum())}
        for r in candidates:
            t0 = time.perf_counter()
            t, h = solve_rays(o, d, ctrl, r, chunk)
            seconds[str(r)] = seconds.get(str(r), 0.0) + time.perf_counter() - t0
            row[str(r)] = score(t64, h64, t, h)
        rows[name] = row
        print(json.dumps({name: row}), flush=True)
    return rows, seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=N_RAYS, help="photon and grazing rays")
    ap.add_argument("--res", type=int, default=RES, help="the eye population's canvas")
    ap.add_argument("--chunk", type=int, default=None,
                    help="rays a solve (default: all on the card, 256 on the CPU)")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "NEWTON_RESTARTS_PORT.json"))
    args = ap.parse_args(argv)

    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    chunk = args.chunk if args.chunk is not None else (0 if device.type == "cuda" else 256)
    ctrl = study_ctrl(device)
    pops = populations(ctrl, args.n, args.res)
    t0 = time.perf_counter()
    rows, seconds = study(pops, ctrl, chunk=chunk)
    reduced = []
    if args.n != N_RAYS:
        reduced.append(f"photon and grazing rays {N_RAYS} -> {args.n}")
    if args.res != RES:
        reduced.append(f"eye canvas {RES}^2 -> {args.res}^2")
    record = {"oracle_restarts": ORACLE, "iters": ITERS,
              "n_rays": {k: int(v[0].shape[0]) for k, v in pops.items()},
              "backend": device.type, "pops": rows,
              "solver": "ops/newton_kernel.make_newton (kernel #1 on the card, "
                        "its plain twin on the CPU)",
              "seconds_by_restarts": seconds,
              "seconds": time.perf_counter() - t0,
              **record_fields(device), "reduced": reduced}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
