#!/usr/bin/env python3
"""Where the port's runs on the card and on the CPU round differently.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_rounding_probe.py

1. The elementwise operations a walk segment uses, on the same float32
   inputs on the card and on the CPU: the share of results that differ and
   the largest difference in ulps.
2. A 32 x 32 pass (2 rounds x 1024 photons) run free on the card and on the
   CPU with the same draws, both recorded segment by segment: per segment,
   the lanes whose decisions differ (hit point or continuation for the eye,
   deposit or alive for photons) and the largest hit-point difference, so
   the segment where the two runs split shows.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def op_table(device) -> None:
    from raytrace3_tpu_torch.core.vecmath import dot

    gen = torch.Generator().manual_seed(0)
    n = 1 << 20
    u = lambda lo, hi: torch.rand(n, generator=gen) * (hi - lo) + lo
    v3 = lambda: torch.randn((n, 3), generator=gen) * 50
    ops = {
        "sqrt": (torch.sqrt, (u(0, 1e4),)),
        "sin": (torch.sin, (u(0, 2 * math.pi),)),
        "cos": (torch.cos, (u(0, 2 * math.pi),)),
        "acos": (torch.acos, (u(-1, 1),)),
        "div": (torch.div, (u(-300, 300), u(1e-3, 1))),
        "mul": (torch.mul, (u(-300, 300), u(-1, 1))),
        "dot3 (a*b).sum(-1)": (lambda a, b: (a * b).sum(-1), (v3(), v3())),
        "dot3 vecmath.dot": (dot, (v3(), v3())),
        "exp": (torch.exp, (u(-20, 0),)),
        "pow 1/2.2": (lambda x: torch.pow(x, 1 / 2.2), (u(0, 1),)),
        "floor": (torch.floor, (u(-100, 100),)),
    }
    print("[ops] op: share of results that differ card vs CPU, largest ulps")
    for name, (fn, args) in ops.items():
        want = fn(*args)
        got = fn(*(a.to(device) for a in args)).cpu()
        d = _ulps(got.contiguous(), want.contiguous())
        print(f"[ops] {name:20s} {float((d > 0).double().mean()):.3e}  {int(d.max())}")


def split_segments(device) -> None:
    import chip_smoke
    from raytrace3_tpu_torch.core.sampling import (GeneratorDraws, RecordingDraws,
                                                   ReplayDraws)
    from raytrace3_tpu_torch.testing import recording_segments

    small = dict(chip_smoke.BENCH, width=32, height=32, rounds=2,
                 photons_per_round=1024, atlas_res=32)
    draws = RecordingDraws(GeneratorDraws(torch.Generator().manual_seed(0)))
    _, _, fn_cpu = chip_smoke.make_pass(small, "cpu")
    with recording_segments() as cpu:
        img_c, _ = fn_cpu(draws)
    _, _, fn_gpu = chip_smoke.make_pass(small, device)
    with recording_segments() as gpu:
        img_g, _ = fn_gpu(ReplayDraws(draws.arrays, device=device))
    for k, ((_, (c_l, _, c_r)), (_, (g_l, _, g_r))) in enumerate(zip(cpu["eye"], gpu["eye"])):
        dec = int(((c_r[:, 10] != g_r[:, 10]) | (c_l[4] != g_l[4])).sum())
        dpos = float((c_r[:, :3] - g_r[:, :3]).abs().amax(-1).max())
        print(f"[split] eye segment {k}: {dec} lanes decide differently, "
              f"largest |d pos| {dpos:.3g}")
    for k, ((_, (c_c, c_r)), (_, (g_c, g_r))) in enumerate(zip(cpu["photon"], gpu["photon"])):
        dec = int(((c_r[3] != g_r[3]) | (c_c[3] != g_c[3])).sum())
        live = c_r[3] & g_r[3]
        dpos = (c_r[0] - g_r[0]).abs().amax(-1)
        rel = dpos / c_r[0].norm(dim=-1).clamp_min(1.0)
        print(f"[split] photon segment {k}: {dec} lanes decide differently, "
              f"largest relative |d pos| on common deposits "
              f"{float(rel[live].max()) if bool(live.any()) else 0.0:.3g}")
    l1 = float((img_g.cpu() - img_c).abs().sum() / img_c.abs().sum())
    print(f"[split] free-running image relative L1 card vs CPU {l1:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    op_table(device)
    split_segments(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
