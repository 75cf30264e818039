#!/usr/bin/env python3
"""Where a pass of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/torch_profile_pass.py [--res 512] [--rounds 16]
        [--photons 131072] [--out chiprun_out/torch_profile.json]

Runs the port's main path (the bench configuration of ``chip_smoke.py``)
and reports, after one warm pass:

  * a stage breakdown of one pass, timed on the host clock with the device
    synchronised at every stage boundary: eye pass, photon walk (per
    round), deposit (per round), the rest;
  * one unsynchronised pass under ``torch.profiler``: the pass wall time,
    the summed device time of its kernels (so the device's idle share), the
    number of kernel launches, and the kernels with the most device time.

The synchronised breakdown costs the pipelining between stages, so its
total exceeds the plain pass time; the profiled pass shows that overlap.
The JSON record goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import BENCH, card_line, make_pass  # noqa: E402


def timed(fn, bucket: dict, name: str):
    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        bucket[name] += time.perf_counter() - t0
        return out
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=BENCH["width"])
    ap.add_argument("--rounds", type=int, default=BENCH["rounds"])
    ap.add_argument("--photons", type=int, default=BENCH["photons_per_round"])
    ap.add_argument("--out", default="chiprun_out/torch_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from raytrace3_tpu_torch.render import sppm

    device = torch.device("cuda", 0)
    card = card_line()
    settings = dict(BENCH, width=args.res, height=args.res, rounds=args.rounds,
                    photons_per_round=args.photons)
    cfg, scene, fn = make_pass(settings, device)
    gen = torch.Generator(device=device).manual_seed(0)
    fn(gen)                                              # warm
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    fn(gen)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0

    # One unsynchronised pass under the profiler.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(gen)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]

    # One pass with the device synchronised at stage boundaries.
    stages = defaultdict(float)
    orig = (sppm.eye_pass, sppm.photon_trace_regen)
    sppm.eye_pass = timed(orig[0], stages, "eye_pass")
    sppm.photon_trace_regen = timed(orig[1], stages, "photon_walk")
    from raytrace3_tpu_torch.ops.deposit_kernel import DepositTile
    orig_call = DepositTile.packed_call
    DepositTile.packed_call = timed(orig_call, stages, "deposit")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(gen)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
    finally:
        sppm.eye_pass, sppm.photon_trace_regen = orig
        DepositTile.packed_call = orig_call
    stages["rest"] = sync_s - sum(stages.values())

    record = {
        "card": card, "torch": torch.__version__,
        "config": {k: settings[k] for k in ("width", "height", "rounds",
                                             "photons_per_round")},
        "pass_s": pass_s,
        "profiled_pass_wall_s": prof_wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall_s,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:120], "device_ms": v[0] / 1e3, "count": v[1]}
                        for n, v in top],
        "synced_pass_s": sync_s,
        "synced_stages_s": dict(stages),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"{card}: pass {pass_s:.3f} s; profiled pass {prof_wall_s:.3f} s with "
          f"{busy_us / 1e6:.3f} s of kernels ({len(kernels)} launches), idle share "
          f"{record['device_idle_share']:.3f}")
    print("synced stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    for t in record["top_kernels"]:
        print(f"  {t['device_ms']:9.2f} ms  x{t['count']:6d}  {t['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
