#!/usr/bin/env python3
"""Where a train step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/torch_profile_train.py [--res 256] [--rounds 4]
        [--photons 32768] [--out chiprun_out/torch_profile_train.json]

Runs the port's train path (``chip_smoke.py``'s phase 9 configuration,
``scripts/perf_trainstep.py``'s settings) and reports, after one warm step:

  * the plain step time and the peak device memory of a step;
  * one unsynchronised step under ``torch.profiler``: its wall time, the
    summed device time of its kernels (so the device's idle share), the
    number of kernel launches, the port's own kernels' device time and
    launches, and the kernels with the most device time;
  * a stage breakdown of one step, timed on the host clock with the device
    synchronised at every stage boundary: eye pass, photon walk, deposit
    forward (host side + kernel #3), the rest of the forward, the backward
    (all of autograd, kernel #4 included), the optimizer step.

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

from chip_smoke import RESTARTS, TRAIN  # noqa: E402
from raytrace3_tpu_torch.core.device import card_line  # noqa: E402

#: The port's kernels by the name the profiler gives their device code.
PORT_KERNELS = ("newton_kernel", "deposit_lane_kernel", "deposit_lane_bwd_kernel",
                "deposit_tile_kernel")


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
    ap.add_argument("--res", type=int, default=TRAIN["width"])
    ap.add_argument("--rounds", type=int, default=TRAIN["rounds"])
    ap.add_argument("--photons", type=int, default=TRAIN["photons_per_round"])
    ap.add_argument("--out", default="chiprun_out/torch_profile_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from raytrace3_tpu_torch.diff import train
    from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render import sppm
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    device = torch.device("cuda", 0)
    card = card_line()
    settings = dict(TRAIN, width=args.res, height=args.res, rounds=args.rounds,
                    photons_per_round=args.photons)
    cfg = RenderConfig(**settings)
    scene = build_scene(cfg, device)
    newton = make_newton(cfg.newton_iters, RESTARTS)
    render = train.make_render_fn(scene, cfg, newton_fn=newton)
    gen = lambda: torch.Generator(device=device).manual_seed(0)
    p_true = train.extract_params(scene)
    with torch.no_grad():
        target = render(p_true, gen())
    params = dict(p_true, diff=p_true["diff"] * 0.5)
    opt = train.adam(1e-2)([v.requires_grad_(True) for v in params.values()])

    def step(stages=None):
        clock = (lambda name, fn: timed(fn, stages, name)) if stages is not None else (
            lambda name, fn: fn)
        opt.zero_grad(set_to_none=True)
        img = clock("forward", lambda: render(params, gen()))()
        loss = ((img - target) ** 2).mean()
        clock("backward", loss.backward)()
        clock("optimizer", opt.step)()
        return loss

    step()                                               # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    port = {k: {"device_ms": sum(v[0] for n, v in by_name.items() if k in n) / 1e3,
                "launches": sum(v[1] for n, v in by_name.items() if k in n)}
            for k in PORT_KERNELS}
    port = {k: v for k, v in port.items() if v["launches"]}
    port_ms = sum(v["device_ms"] for v in port.values())

    # One step with the device synchronised at stage boundaries.
    stages = defaultdict(float)
    orig = (sppm.eye_pass, sppm.photon_trace, DepositLane.__call__)
    sppm.eye_pass = timed(orig[0], stages, "eye_pass")
    sppm.photon_trace = timed(orig[1], stages, "photon_walk")
    DepositLane.__call__ = timed(orig[2], stages, "deposit_forward")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(stages)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
    finally:
        sppm.eye_pass, sppm.photon_trace, DepositLane.__call__ = orig
    stages["forward_rest"] = stages.pop("forward") - sum(
        stages[k] for k in ("eye_pass", "photon_walk", "deposit_forward"))
    stages["rest"] = sync_s - sum(stages.values())

    record = {
        "card": card, "torch": torch.__version__,
        "config": {k: settings[k] for k in ("width", "height", "rounds",
                                             "photons_per_round")},
        "step_s": step_s,
        "peak_memory_gb": peak_gb,
        "profiled_step_wall_s": prof_wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall_s,
        "kernel_launches": len(kernels),
        "port_kernels": port,
        "port_kernels_share_of_step": port_ms / 1e3 / prof_wall_s,
        "top_kernels": [{"name": n[:120], "device_ms": v[0] / 1e3, "count": v[1]}
                        for n, v in top],
        "synced_step_s": sync_s,
        "synced_stages_s": dict(stages),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"{card}: step {step_s:.3f} s, peak memory {peak_gb:.2f} GB; profiled step "
          f"{prof_wall_s:.3f} s with {busy_us / 1e6:.3f} s of kernels ({len(kernels)} "
          f"launches), idle share {record['device_idle_share']:.3f}")
    print("port kernels: " + ", ".join(f"{k} {v['device_ms']:.2f} ms x{v['launches']}"
                                       for k, v in port.items())
          + f" ({record['port_kernels_share_of_step']:.3%} of the profiled step)")
    print("synced stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    for t in record["top_kernels"]:
        print(f"  {t['device_ms']:9.2f} ms  x{t['count']:6d}  {t['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
