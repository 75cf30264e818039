#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port: photons/s on the 512x512 teapot
caustics scene, one card.

The port's counterpart of ``bench.py``, with its configuration and knobs
(``BENCH``: scene ``full``, 512^2, 16 rounds x 131072 photons, depth 13,
atlas 128, Bezier compaction 0.09 / 0.05, hit-point factor 1.3, the regen
walk, the eye schedule ((1, .25), (4, .04), (6, .02)); the tile deposit at
tile 256 / chunk 2048 with 1-D banding, the Newton kernel at 8 restarts x 10
iterations).  Prints ONE JSON line with ``bench.py``'s keys and ``card``,
the ``nvidia-smi`` name and power limit of the card (null on the CPU), then
asserts that both drop counters, summed over every pass, are zero.

``vs_baseline`` is against the C++ baseline of the reference algorithm
(native/baseline_sppm.cpp), built and timed on this host's CPU by
``bench.measure_cpp_baseline``; a failed build prints its reason to stderr
and leaves it null.

Env knobs (``bench.py``'s, same defaults): RT3_BENCH_ROUNDS,
RT3_BENCH_PHOTONS, RT3_BENCH_RES, RT3_BENCH_TIMED (timed passes, 4),
RT3_BENCH_PLATFORM (``cpu``: the CPU and the kernels' plain twins; else the
card, and without one the bench raises), RT3_BENCH_PALLAS (0: the default
Bezier solver ``solve_winner``), RT3_BENCH_RESTARTS (8), RT3_BENCH_DEPFRAC
(deposit compaction, 1.0), RT3_BENCH_WCHUNK (2048), RT3_BENCH_WORKCAP
(16384, the block deposit's), RT3_BENCH_DEPCLS (``tile`` or ``block``),
RT3_BENCH_DEPTILE (256, or 512 for ``block``), RT3_BENCH_DEP2D (1: 2-D
banding); and RT3_BENCH_BASELINE=0, which skips the C++ baseline.

Run on the card: ``python3 bench_torch.py``; on the CPU at a small size:
``RT3_BENCH_PLATFORM=cpu RT3_BENCH_RES=32 RT3_BENCH_ROUNDS=2
RT3_BENCH_PHOTONS=1024 RT3_BENCH_TIMED=1 RT3_BENCH_BASELINE=0 python3
bench_torch.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np
import torch

from bench import measure_cpp_baseline

#: The bench's render settings (bench.py:109-119) as ``RenderConfig``
#: keywords; ``RT3_BENCH_RES``, ``_ROUNDS`` and ``_PHOTONS`` override the
#: width, height, rounds and photons a round.  chip_smoke.py drives its
#: render phases from these.
BENCH = dict(scene="full", width=512, height=512, passes=1, rounds=16,
             photons_per_round=131072, max_depth=13, atlas_res=128,
             bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
             newton_iters=10, hitpoint_factor=1.3, photon_regen=True,
             eye_compact_schedule=((1, 0.25), (4, 0.04), (6, 0.02)))
#: Newton kernel restarts a patch and the tile deposit's tile (the
#: ``RT3_BENCH_RESTARTS`` and ``RT3_BENCH_DEPTILE`` defaults).
RESTARTS = 8
TILE = 256
#: The reference camera (main.cpp:24, 27).
BASE = np.array([50.0, 35.0, 230.0])
LOOK = BASE + np.array([0.0, 0.042612, -1.0])
#: The world bounds of 1-D banding.
BOUNDS = ("x_lo", "x_hi", "y_lo", "y_hi")


def knobs(env=os.environ) -> dict:
    """The bench's settings from the ``RT3_BENCH_*`` variables of ``env``,
    with ``bench.py``'s defaults."""
    dep_cls = env.get("RT3_BENCH_DEPCLS", "tile")
    return dict(
        rounds=int(env.get("RT3_BENCH_ROUNDS", BENCH["rounds"])),
        photons=int(env.get("RT3_BENCH_PHOTONS", BENCH["photons_per_round"])),
        res=int(env.get("RT3_BENCH_RES", BENCH["width"])),
        timed=int(env.get("RT3_BENCH_TIMED", "4")),
        platform=env.get("RT3_BENCH_PLATFORM"),
        pallas=env.get("RT3_BENCH_PALLAS", "1") != "0",
        restarts=int(env.get("RT3_BENCH_RESTARTS", RESTARTS)),
        depfrac=float(env.get("RT3_BENCH_DEPFRAC", "1.0")),
        wchunk=int(env.get("RT3_BENCH_WCHUNK", "2048")),
        work_cap=int(env.get("RT3_BENCH_WORKCAP", "16384")),
        dep_cls=dep_cls,
        dep_tile=int(env.get("RT3_BENCH_DEPTILE", TILE if dep_cls == "tile" else 512)),
        dep_2d=env.get("RT3_BENCH_DEP2D", "0") == "1",
        baseline=env.get("RT3_BENCH_BASELINE", "1") != "0",
    )


def build(k: dict, device):
    """(cfg, pass function, whether the Newton kernel solves) of the bench
    settings ``k`` on ``device``."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (DepositBlock, DepositTile,
                                                        world_bounds_from_scene)
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene, make_pass_fn
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**dict(
        BENCH, width=k["res"], height=k["res"], rounds=k["rounds"],
        photons_per_round=k["photons"], newton_restarts=4, update_mode="sppm",
        deposit="pallas", deposit_compact_frac=k["depfrac"]))
    scene = build_scene(cfg, device)
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    bounds = b if k["dep_2d"] else {n: b[n] for n in BOUNDS}
    if k["dep_cls"] == "tile":
        deposit_fn = DepositTile(tile=k["dep_tile"], chunk=k["wchunk"],
                                 bucket2d=k["dep_2d"], **bounds)
    elif k["dep_cls"] == "block":
        deposit_fn = DepositBlock(tile=k["dep_tile"], wchunk=k["wchunk"],
                                  work_cap=k["work_cap"], bucket2d=k["dep_2d"], **bounds)
    else:
        raise ValueError(f"RT3_BENCH_DEPCLS must be tile or block, not {k['dep_cls']!r}")
    newton_fn = make_newton(cfg.newton_iters, k["restarts"]) if k["pallas"] else None
    fn = make_pass_fn(scene, cfg, BASE, LOOK, deposit_fn=deposit_fn, newton_fn=newton_fn)
    return cfg, fn, newton_fn is not None


def _drops(stats: dict) -> torch.Tensor:
    """A pass's (eye rays, deposits) dropped, on the device."""
    return torch.stack([torch.as_tensor(stats[n], dtype=torch.int64)
                        for n in ("dropped", "deposits_dropped")])


def measure(k: dict, cpp: dict | None = None):
    """Run the bench settings ``k``; return (its record, the last pass's
    image (H, W, 3)).  One first pass
    (``compile_seconds``: it builds the kernels at first use), then
    ``k["timed"]`` passes, pass i drawing from ``pass_generator(0, i + 1)``,
    with no host read inside the timed window and one synchronise at its
    end.  The drop counters are summed over every pass, the first one
    included.  ``cpp``: the C++ baseline's record, or None."""
    from raytrace3_tpu_torch.core.device import card_line, resolve_device
    from raytrace3_tpu_torch.render.driver import pass_generator
    from raytrace3_tpu_torch.render.eye import eye_stage_widths

    device = resolve_device("cpu" if k["platform"] == "cpu" else "cuda")
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    cfg, fn, pallas = build(k, device)

    print(f"bench: backend={device.type} first pass (kernel builds) ...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    _, stats = fn(pass_generator(0, 0, device))
    sync()
    compile_s = time.perf_counter() - t0
    drops = [_drops(stats)]

    gens = [pass_generator(0, i + 1, device) for i in range(k["timed"])]
    sync()
    t0 = time.perf_counter()
    emitted_acc = []
    for g in gens:
        img, stats = fn(g)
        emitted_acc.append(stats["photons_emitted"])
        drops.append(_drops(stats))
    emitted = torch.stack(emitted_acc).sum()
    sync()
    dt = (time.perf_counter() - t0) / k["timed"]
    emitted = float(emitted) / k["timed"]
    eye_dropped, deposits_dropped = (int(n) for n in torch.stack(drops).sum(0))

    pps = emitted / dt
    eye_rays = sum(s * w for s, w in eye_stage_widths(
        cfg.n_pixels, cfg.eye_compact_schedule, cfg.max_depth))
    photon_rays = cfg.rounds * (cfg.max_depth + 1) * cfg.photons_per_round
    mrays = (eye_rays + photon_rays) / dt / 1e6
    cpp = cpp or {}
    baseline_pps = float(cpp.get("photons_per_s", "nan"))
    record = {
        "metric": "photons_per_s_teapot512",
        "value": round(pps, 1),
        "unit": "photons/s",
        "vs_baseline": round(pps / baseline_pps, 3) if baseline_pps == baseline_pps else None,
        "backend": device.type,
        "pallas_newton": pallas,
        "newton_restarts": k["restarts"] if pallas else None,
        "mrays_per_s": round(mrays, 2),
        "pass_seconds": round(dt, 4),
        "compile_seconds": round(compile_s, 1),
        "photons_per_pass": int(emitted),
        "deposits_dropped": deposits_dropped,
        "eye_dropped": eye_dropped,
        "hitpoints": int(stats["count"]),
        "cpp_baseline_photons_per_s": cpp.get("photons_per_s"),
        "cpp_threads": cpp.get("threads"),
        "card": card_line() if cuda else None,
    }
    return record, img


def main() -> int:
    k = knobs()
    cpp = {}
    if k["baseline"]:
        try:
            cpp = measure_cpp_baseline()
        except (OSError, subprocess.SubprocessError, ValueError, KeyError) as e:
            print(f"baseline measurement failed: {e}", file=sys.stderr)
    record, _ = measure(k, cpp)
    print(json.dumps(record))
    # Silently lost flux invalidates the metric: both drop counters must be
    # zero (deposit compaction or work-list overflow, eye-stage clipping).
    assert record["deposits_dropped"] == 0, record
    assert record["eye_dropped"] == 0, record
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
