#!/usr/bin/env python3
"""Time the port's differentiable train step at scale, after
``scripts/perf_trainstep.py``.

    python3 scripts/torch_perf_trainstep.py [--res 256] [--steps 6]
        [--platform cpu] [--out docs/TRAINSTEP_PORT.json]

The step is ``diff.train.make_train_step``'s: a forward SPPM pass of
``full`` (4 x 32768 photons, depth 13, atlas 64, Bezier compaction 0.12 /
0.06, hit-point factor 1.5, the slot eye wavefront and the static walk),
the MSE against a black target, the full backward and an Adam step, with
the default deposit-VJP selection (``diff.train.default_deposit_vjp``: on
the card at 256^2 the lane deposit, kernels #3 and #4) and on the card the
Newton kernel (#1) at 8 restarts.  One warm step (the kernels' first
load), then ``--steps`` timed steps, each from its own generator, one
synchronisation at the end.  Writes ``docs/TRAINSTEP_PORT.json``: JAX's
keys, the peak device memory, both drop counters summed over every step,
the device, the card's name and power limit, and ``reduced``; a run that
dropped an eye ray or a deposit writes nothing and exits 3
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
from raytrace3_tpu_torch.utils.metrics import refuse_drops  # noqa: E402

DEFAULTS = dict(res=256, steps=6, rounds=4, photons=32768)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "TRAINSTEP_PORT.json"))
    args = ap.parse_args(argv)

    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)
    from raytrace3_tpu_torch.diff.train import (default_deposit_vjp, extract_params,
                                                make_train_step)
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(scene="full", width=args.res, height=args.res, rounds=args.rounds,
                       photons_per_round=args.photons, max_depth=13, atlas_res=64,
                       bezier_compact_frac=0.12, bezier_compact_frac_photon=0.06,
                       hitpoint_factor=1.5)
    cuda = device.type == "cuda"
    scene = build_scene(cfg, device)
    newton_fn = make_newton(cfg.newton_iters, 8) if cuda else None
    picked = default_deposit_vjp(scene, cfg)
    init_fn, step_fn = make_train_step(scene, cfg, newton_fn=newton_fn, deposit_fn=picked)
    params = extract_params(scene)
    opt = init_fn(params)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    gen = lambda i: torch.Generator(device=device).manual_seed(i)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    drops = {"dropped": 0, "deposits_dropped": 0}

    def step(i):
        nonlocal params, opt
        params, opt, loss, st = step_fn(params, opt, gen(i), target)
        for k in drops:
            drops[k] += int(st[k])
        return loss

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    loss = step(0)
    sync()
    compile_s = time.perf_counter() - t0
    print(f"trainstep: first step {compile_s:.2f} s loss={float(loss):.4g}",
          file=sys.stderr, flush=True)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        losses.append(step(i + 1))
    sync()
    dt = (time.perf_counter() - t0) / args.steps
    record = {
        "what": "full differentiable SPPM train step (fwd+bwd+adam), default deposit-VJP "
                "selection",
        "res": args.res,
        "photons_per_step": cfg.rounds * cfg.photons_per_round,
        "backend": device.type,
        "deposit_backend_selected": getattr(picked, "__name__", type(picked).__name__),
        "deposit_differentiable": bool(getattr(picked, "differentiable", False)),
        "newton": "kernel #1, 8 restarts" if cuda else "solve_winner",
        "steps_timed": args.steps,
        "step_seconds": dt,
        "compile_seconds": compile_s,
        "loss_finite": bool(np.isfinite(float(losses[-1]))),
        "losses": [float(x) for x in losses],
        "peak_device_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
        "eye_dropped_total": drops["dropped"], "deposits_dropped_total": drops["deposits_dropped"],
        **record_fields(device),
        "reduced": [f"{k} {v} -> {getattr(args, k)}" for k, v in DEFAULTS.items()
                    if getattr(args, k) != v],
    }
    refuse_drops(drops, f"train step at {args.res}^2 over {args.steps + 1} steps")
    if not record["loss_finite"]:
        raise SystemExit(f"the train step failed: {record}")
    if cuda and record["deposit_backend_selected"] != "DepositLane":
        raise SystemExit(f"the default deposit VJP at {args.res}^2 on the card is "
                         f"{record['deposit_backend_selected']}, not the lane deposit")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
