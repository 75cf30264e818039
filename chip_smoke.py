#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``raytrace3_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's six CUDA kernels, the regen walk's segment kernels
(``walk.cu``) and the staged eye's (``eye.cu``) from
``raytrace3_tpu_torch/csrc/`` and drives the
port's paths: the render pass, the train step, the CLI, the stream
deposit's pass and the sharded render and train step (phases
16-18, in spawned ranks; with more cards the ranks take one each).  The
render path is the port bench's
(``bench_torch.py``: ``bench.py``'s configuration, scene ``full``, 512 x
512, 16 rounds x 131072 photons, depth 13, regen walk, Bezier compaction
0.09 / 0.05, the staged eye schedule, the tile deposit at tile 256 with
1-D banding, Newton at 8 restarts x 10 iterations).  The train path is
``scripts/perf_trainstep.py``'s (scene ``full``, 256 x 256, 4 rounds x 32768
photons, depth 13, atlas 64, Bezier compaction 0.12, hit-point factor 1.5,
the slot eye wavefront and the static photon walk, the differentiable lane
deposit at tile 256 / chunk 512 / work cap 16384 with 2-D banding and
merged z windows, Adam on an MSE loss).  Phases, each of which ends the run
with a non-zero exit when it fails:

  1. the card's name and power limit; build the eight sources, in parallel;
  2. the Newton kernel against its plain PyTorch twin on the teapot-bound
     rays of one photon segment at bench shapes, bit for bit, with the open
     (ray, patch) pairs, the rays a block and the queue drains, and its
     bound counted per (ray, patch) beside the first version's per-lane
     count (and the time of the default solver, ``solve_winner``, on the
     same rays);
  3. the tile deposit kernel against its plain twin on one bench round
     (14 x 131072 deposits against the 512^2 hit-point layout), the flux
     held to the twin summed in float64, with its launch geometry, the
     lanes per tile, and its time over its bound and over its instruction
     floor (twice the bound under -fmad=false);
  4. a small pass (32 x 32, 2 x 1024 photons) on the card against the same
     pass on the CPU (the plain twins) with the same draws, held to it one
     walk segment at a time (``raytrace3_tpu_torch.testing``);
  5. the render path: the port bench's own measurement
     (``bench_torch.measure`` at ``bench_torch.py``'s defaults: one first
     pass and 4 timed passes), with the kernels' launch counters read around
     it (Newton, the tile deposit, the three walk kernels and the three eye
     kernels launched) and
     the bench's JSON record printed;
  6. the lane deposit kernel against its plain twin on one train round
     (14 x 32768 deposits against the 256^2 hit-point layout), the flux held
     to the twin summed in float64, with its launch geometry, items per
     tile and lanes per item;
  7. its transpose, the backward kernel, against its plain twin on the
     same inputs with a seeded cotangent, held to the twin summed in
     float64 and to itself bit for bit over two calls;
  8. a small train step (16 x 16, 2 x 256 photons, the teapot in view) on
     the card against the same step on the CPU with the same draws, walks
     held segment by segment: loss and gradients;
  9. the train path: ``build_scene`` + ``make_train_step`` at full width,
     one warm step and timed steps from half the true albedos toward a
     target rendered at the true ones, with the launch counters read
     around them; then its params and Adam state through ``save_tree`` /
     ``load_tree`` on the card, restored bit for bit;
 10. the block deposit kernel (#5) against its plain twin at the
     ``reference1024`` preset's shapes: the 1024^2 eye pass with the
     preset's schedule and one regen round (14 x 131072 deposits) through
     ``DepositBlock`` as ``cli.py`` builds it (tile 1024, work cap 65536),
     with the same float64-summed twin, geometry and timing lines as
     phase 3;
 11. the CLI path: ``cli.main(["--preset", "reference1024", "--passes",
     "3", ...])`` in process, with its metrics JSONL, checkpoint and PNG,
     the launch counters read around it; then a 64^2 render on the card
     resumed from a one-pass checkpoint against the same render run
     straight;
 12. the stream deposit kernel (#6) against its plain twin (held to the twin
     summed in float64, with its launch geometry, as phases 3 and 10) and the
     coarse-z ``DepositZTile`` against ``DepositTile`` on phase 3's bench
     round, and one 512^2 pass through ``make_pass_fn`` with
     ``DepositStream``;
 13. the K-slot eye wavefront: a 64 x 64 pass at 2 slots a pixel (2 x 1024
     photons, the Newton kernel) on the card against the same pass on the
     CPU with the same draws, held segment by segment as phase 4 holds its
     pass;
 14. deposit compaction on phase 3's bench round: at a fraction above the
     valid share the tile deposit's counts equal the uncompacted round's
     and its flux agrees to DEPOSIT_FLUX_RTOL; at a fraction that cuts,
     the drop count is valid - cap exactly;
 15. the Epanechnikov deposit on the card against the CPU at the
     finite-difference test's size (forward, and gradients w.r.t. deposit
     positions, hit positions and r2), and the peak memory of one train
     step at 64^2 through ``deposit_bruteforce_epa``;
 16. the sharded render (``parallel.shard.render_sharded``) at the
     ``sharded10m`` preset's width with the kernels (``--pallas --deposit
     tile --regen``), one rank a card over NCCL in spawned processes that
     load phase 1's kernels; on one card the 1 x 1 sharded pass equals
     ``make_pass_fn``'s with the same generator bit for bit.  Each rank
     holds the kernels to their twins on the inputs the run gave them
     (``held_inputs``, ``hold_kernels``): the tile deposit's first call
     (the gathered hit points against the rank's round) and a Newton call
     on a photon segment of round 1, bit for bit;
 17. two ranks on the one card over gloo, every collective staged through
     host memory (printed): the 1 x 2 photon-axis pass and the
     ``--hp-sharded`` ring at that width, then a 2-rank sharded train step
     at train256's; images, gradients and params equal across ranks (with
     two cards the same again over NCCL).  Each rank holds its kernels as
     phase 16 does: on the ring the tile deposit's second call (a hop: the
     neighbour's deposits against the rank's shard of the layout), and in
     the train step the lane deposit and its transpose on the first round's
     inputs (the gathered hit points, the rank's deposits, the cotangent
     the loss gave);
 18. the port's dry run (``parallel/dryrun.py``) on 8 ranks, the 2 x 4
     mesh of MULTICHIP_r05.json, as phase 17 runs its ranks (gloo, one
     card); every rank agrees and kernels #1-#4 are launched;
 19. the Newton kernel against its plain twin, bit for bit, at 4, 16, 32
     and 64 restarts (the path runs 8) on the restart study's three ray
     populations (``scripts/torch_newton_restart_study.py``) cut to 16,384
     rays each, with its times, bound, open pairs and lane fill per restart
     count, then the study's metrics at that cut;
 20. the grad check's ``cuda+lane`` column (``scripts/torch_gradcheck.py``),
     its ctrl group cut to MIN_CHECKED coordinates of one realisation: the
     pass rate printed, a non-finite gradient failing, and the lane
     deposit and its transpose held to their twins on the first round's
     inputs as phase 17 holds them;
 21. ten steps of the albedo recovery at 128^2
     (``scripts/torch_inverse_render.py``): the loss falls, both drop
     counters are 0, s/step printed;
 22. the host-side micro-benchmarks cut (``scripts/torch_perf_dispatch_
     micro.py`` on the bench's pass at 4 rounds, n = 2, with its launches
     and syncs a pass; ``torch_perf_compact_micro.py`` and
     ``torch_perf_depprep_micro.py`` at their full shapes): every
     candidate's output equal to the others', the port's deposit prep to
     its row-gather twin.
 23. ``raytrace3_tpu_torch.entry.entry()`` on the card (finite, positive,
     no drop, equal bit for bit to ``make_pass_fn``'s pass on the same
     generator); ``scripts/torch_asset_render.py`` at 64^2 and 2 passes on
     wall, timg and planet images the phase writes (the atlas read from
     them, no drop); the bisect (``full`` and ``nonewton`` at 64^2, 4
     rounds), the deposit micro at its shapes and three rows of the sweep
     (the block row, the bench's tile row, a coarse-z row), each with 5
     timed calls; the kernels' launches over the phase are the path
     ``finish``.  Every kernel the phase runs is held to its plain twin on
     the phase's own inputs (``held_inputs``, ``hold_kernels``): the asset
     render's tile deposit (#2) and a Newton call of its walk (#1, 8
     restarts); the bisect's block deposit (#5 at tile 512 / wchunk 1024 /
     work cap 16384) and a Newton call of its full pass (#1, 16 restarts);
     the micro's block deposit; and each sweep row's whole call against
     the same call through its kernel's plain twin (counts exactly, flux to
     DEPOSIT_FLUX_RTOL), its counts also equal across the rows.
 24. (run after phase 2) the regen walk's kernels (``walk.cu``:
     ``walk_refill``, ``walk_compact``, ``walk_bezier``, ``walk_shade``)
     against their plain twin, the op code of
     ``photon.regen_segment_plain``, on the main path's round at 131,072
     lanes (the bench's) and at 1,048,576: 14 segments, each from the
     twin's carry on the same draws, every lane of the carry and the record
     bit for bit, and ``walk_compact``'s launches a segment; then each
     kernel's device time beside its byte bound (``walk_compact``'s a
     middle, its outputs held bit for bit to the twin's sort and gathers),
     the segment's least time, and a whole segment through the kernels and
     through the twin.
 25. (run after phase 24) the staged eye's kernels (``eye.cu``: ``eye_hit``,
     ``eye_shade``, and ``walk.cu``'s row kernel as ``eye_bezier``) against
     their plain twin, the op code of ``eye.eye_segment_plain``, on the main
     path's own eye: the bench's 262,144 camera rays through its grown
     staged schedule, every segment on the same lanes through both, the
     twin's output going on; every lane of the next lanes and the hit-point
     rows, and the count dropped, bit for bit.  Then each kernel's device
     time on the first segment beside its byte bound (and ``walk_compact``'s
     a middle, held bit for bit to the twin's sort and gathers), the
     segment's least time, and a whole segment through the kernels and
     through the twin.

A kernel's ``ms`` is its device time (``device_ms``: a CUDA graph of 10
launches, replayed); ``call_ms`` is one wrapper call between CUDA events,
which adds the host's share the device waits for.  The second-to-last
line is a JSON object with one entry per kernel; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing either.  It imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import struct
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# The main path and its settings are the port bench's (bench.py:109-119).
import bench_torch
from bench_torch import BASE, BENCH, BOUNDS, LOOK, RESTARTS, TILE

#: Newton: the kernel evaluates in the plain twin's operation order and
#: contracts a product into an add (``__fmaf_rn``) exactly where the twin's
#: ``fma32`` does, so hits, patch ids and t, u, v must agree bit for bit.
NEWTON_ATOL = 0.0
#: Deposit: counts exactly; flux sums differ only in summation order (the
#: plain twin accumulates with atomics), DEPOSIT_FLUX_RTOL of a slot's flux.
#: Phases 3 and 10 hold the kernel to the twin with its flux summed in
#: float64 (each slot's sum rounded once): the float32 twin's own rounding
#: over thousands of passes on a caustic slot takes it 6.4e-6 from that on
#: these rounds, the kernel 1.2e-6 at most (PERF.md section 6).  The
#: float32 twin's distances are printed beside it.
DEPOSIT_FLUX_RTOL = 1e-5
#: Card vs CPU pass, the walks held segment by segment: every counter equal;
#: the image within SMALL_L1_RTOL relative L1, since the deposit stage then
#: sees identical hit points and deposits and its flux sums differ in order
#: only (DEPOSIT_FLUX_RTOL).
SMALL_L1_RTOL = 1e-5
#: The train path's settings (scripts/perf_trainstep.py:53-64).
TRAIN = dict(scene="full", width=256, height=256, rounds=4, photons_per_round=32768,
             max_depth=13, atlas_res=64, bezier_compact_frac=0.12,
             bezier_compact_frac_photon=0.06, newton_iters=10, hitpoint_factor=1.5)
TIMED_STEPS = 3
#: Phase 8's small train step, tests/test_torch_train.py's: the camera and
#: the light on the teapot, so that ctrl gets a gradient.
SMALL_TRAIN = dict(scene="full", width=16, height=16, rounds=2, photons_per_round=256,
                   max_depth=13, atlas_res=16, bezier_compact_frac=0.5,
                   hitpoint_factor=1.5)
SMALL_POSE = ((30.0, 20.0, 170.0), (20.0, 5.0, 120.0))
SMALL_LIGHT = [[35.0, 15.0, 125.0]]
SMALL_LANE = dict(tile=32, chunk=128, work_cap=2048)
#: Loss of the card's held step against the CPU's (the deposit sums differ
#: in order only), and gradients per parameter relative to its largest:
#: the tolerance tests/test_torch_train.py states for the port against
#: JAX, whose causes (gradients taken at each side's own values along the
#: held path) are the same here.
SMALL_LOSS_RTOL = 1e-5
SMALL_GRAD_ATOL = 2e-3
#: H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores and
#: HBM bandwidth.  A kernel's bound is the larger of its operations over the
#: first and its bytes (each input read once, each output written once) over
#: the second.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
#: fp32 operations per deposit pair test (csrc/deposit_pair.cuh: 8 for d2,
#: 5 for ndot, 2 compares) and per pair taken (4 adds forward, 3 backward).
PAIR_OPS, TAKEN_OPS_FWD, TAKEN_OPS_BWD = 15, 4, 3
#: fp32 operations of the Newton kernel (csrc/newton.cu), counted from the
#: source: per patch its box (45 min and 45 max, once, as the TPU kernel's
#: table), per ray its three reciprocals, per (ray, patch) pair the slab test
#: (6 subtractions, 6 products, 6 NaN tests, 6 min/max for the slabs, 4 for
#: tnear and tfar, the clamp at 0 and the compare); per (pair, restart) lane
#: whose box opens, the start (one patch evaluation, 142, and t0, 8) and per
#: iteration a patch evaluation with derivatives (316), the Cramer step (63),
#: the clamps (24), a patch evaluation (142), the residual (14) and the
#: acceptance test (7).
NEWTON_BOX_OPS, NEWTON_RAY_OPS, NEWTON_PAIR_OPS = 90, 3, 30
NEWTON_START_OPS, NEWTON_ITER_OPS = 150, 566
#: The first version's count: the box and slab test on every (ray,
#: patch, restart) lane, 543 operations an iteration; printed beside the
#: new one.
NEWTON_V1_GATE_OPS, NEWTON_V1_ITER_OPS = 120, 543
#: Phase 24: the regen walk's lanes a round on the main path (the bench's
#: 131,072 photons, and 1,048,576, the bigrounds benchmark cell's round),
#: and the segment whose kernels are timed (origins spread over the room).
WALK_LANES = (131072, 1048576)
WALK_TIMED_SEGMENT = 3
#: Phase 25: the eye segment whose kernels are timed (the first: every
#: camera ray).
EYE_TIMED_SEGMENT = 0
#: Phase 11: the CLI's passes at the reference1024 preset, and the card's
#: resume check: a 64^2 render resumed from a one-pass checkpoint against
#: the same render run straight.  The walks are deterministic on the card;
#: only the pixel estimate's index_add_ sums with atomics, in another order
#: each run, so the images agree to RESUME_L1_RTOL relative L1.
CLI_PASSES = 3
RESUME_ARGS = ["--scene", "full", "--res", "64", "--deposit", "pallas", "--pallas",
               "--preview-every", "0"]
RESUME_L1_RTOL = 1e-6
#: Phase 13: the K-slot pass, phase 4's cut of the bench at 64^2 with the
#: slot wavefront at 2 slots (the staged schedule needs one slot).
KSLOT = dict(BENCH, width=64, height=64, rounds=2, photons_per_round=1024, atlas_res=32,
             slots=2, eye_compact_schedule=())
#: Phase 15: the Epanechnikov deposit, card against CPU: counts exact, flux
#: to EPA_FLUX_RTOL and gradients to EPA_GRAD_ATOL of each one's largest
#: (tests/test_torch_epa.py's bounds against JAX); the train step at 64^2.
EPA_FLUX_RTOL = 1e-5
EPA_GRAD_ATOL = 1e-4
EPA_TRAIN = dict(TRAIN, width=64, height=64)
#: Phase 12: the round-3 deposit sweep's stream configuration
#: (scripts/perf_deposit_sweep.py:110-122, ``str1d_t128_ch1024``).
STREAM = dict(tile=128, chunk=1024, work_cap=65536, bucket2d=False)
#: Phases 16-17: the sharded path at its full width, the ``sharded10m``
#: preset (scene ``full``, 512^2, 8 x 131072 photons, depth 13, hit-point
#: factor 2.0) with the kernels as ``rt3-torch --preset sharded10m --pallas
#: --deposit tile --regen`` builds them (the tile deposit #2 at tile 256,
#: Newton #1 at 8 restarts); its 100 passes cut to SHARDED_PASSES (NCCL) and
#: GLOO_PASSES (two ranks on one card over gloo), and phase 17's sharded
#: train step at train256's width to GLOO_TRAIN_STEPS steps.
SHARDED_FLAGS = ["--preset", "sharded10m", "--pallas", "--deposit", "tile", "--regen"]
SHARDED_PASSES = 3
GLOO_PASSES = 2
GLOO_TRAIN_STEPS = 2
#: Seconds a spawned phase may run before its ranks are terminated.
SPAWN_TIMEOUT = 600
#: Phase 18: the dry run's ranks, MULTICHIP_r05.json's 2 x 4 mesh.
DRYRUN_RANKS = 8
#: Phase 19: the restart study's populations (scripts/torch_newton_restart_
#: study.py, JAX's draws) cut to every 16th ray, 16,384 rays each, and every
#: restart count the study solves them at (its candidates and its oracle);
#: the plain twin runs on the rays that open some patch box, STUDY_CHUNK a
#: call (the others must read a miss from the kernel too).
STUDY_RAYS = 16384
STUDY_RESTARTS = (4, 8, 16, 32, 64)
STUDY_CHUNK = 4096
#: Phase 20: the grad check's cuda+lane column, its ctrl group cut to
#: MIN_CHECKED["ctrl"] candidates (the largest gradients) of one
#: realisation.
GRADCHECK_SEED = 0
#: Phase 21: steps of the albedo recovery at 128^2.
INVERSE_STEPS = 10
#: Phase 22: the host-side micro-benchmarks cut: the dispatch tool on the
#: bench's pass at TOOLS_ROUNDS rounds, TOOLS_ISSUE passes issued and one
#: wall reading at n = TOOLS_ISSUE; the compaction and prep tools at their
#: full shapes with TOOLS_REPS timed calls a candidate.
TOOLS_ROUNDS = 4
TOOLS_ISSUE = 2
TOOLS_REPS = 5
#: Phase 23: the asset render cut to FINISH_RES^2 and FINISH_PASSES passes
#: on FINISH_TEXTURES (stem, side) images the phase writes; the bisect's
#: FINISH_VARIANTS at FINISH_RES^2, TOOLS_ROUNDS rounds and one timed pass;
#: the deposit micro at its shapes and the sweep's FINISH_SWEEP rows (JAX's
#: block row, the bench's own tile row, a coarse-z row) at theirs, each
#: with TOOLS_REPS timed calls.
FINISH_RES = 64
FINISH_PASSES = 2
FINISH_TEXTURES = (("wall", 96), ("timg", 48), ("planet", 80))
FINISH_VARIANTS = ("full", "nonewton")
FINISH_SWEEP = ("1d_t512_wc1024_W16k", "tile1d_t256_ch2048_packed",
                "ztile_zc8.0_t128_ch1024_packed")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median time of ``fn()`` over ``reps`` runs, by CUDA events around
    each call: for a kernel wrapper, the device's time plus whatever of the
    host's checks, allocations and launch the device waits for (a
    kernel's ``call_ms``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: Launches a kernel's device time is taken over (``device_ms``).
GRAPH_LAUNCHES = 10


def device_ms(fn, launches: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """A kernel wrapper's device time: ``launches`` calls of ``fn`` captured
    in a CUDA graph after a warm call, the graph replayed ``reps`` times
    between CUDA events; the median over the launches.  The host's work
    stays out of the replays, so this is the kernels' own time (the
    deposits' ``combine_partials`` included)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def kernel_times(fn) -> tuple[float, float]:
    """(device ms, call ms) of a kernel wrapper ``fn``."""
    return device_ms(fn), cuda_ms(fn)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what binds it)."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_row(name, source, replaces, err, times, plain_ms, ops, nbytes) -> dict:
    """A kernel's entry of the ``kernels`` line; ``times`` is
    ``kernel_times``'s (device ms, call ms)."""
    bound_ms, bound_by = bound(ops, nbytes)
    ms, call_ms = times
    return dict(name=name, route="cuda", source=f"raytrace3_tpu_torch/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def make_pass(settings: dict, device, deposit=None, newton_fn=None):
    """(cfg, scene, pass function) of ``settings``; ``deposit(bounds)``
    builds the deposit (default: the bench's tile deposit), ``newton_fn``
    solves the Bezier intersections (default: the Newton kernel's)."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (make_tile_deposit,
                                                        world_bounds_from_scene)
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene, make_pass_fn
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**settings)
    scene = build_scene(cfg, device)
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    xy = {k: b[k] for k in BOUNDS}
    depo = deposit(xy) if deposit is not None else make_tile_deposit(tile=TILE, **xy)
    fn = make_pass_fn(scene, cfg, BASE, LOOK, deposit_fn=depo,
                      newton_fn=newton_fn or make_newton(cfg.newton_iters, RESTARTS))
    return cfg, scene, fn


SOURCES = ("newton.cu", "deposit_tile.cu", "deposit_lane.cu", "deposit_lane_bwd.cu",
           "deposit_block.cu", "deposit_stream.cu", "walk.cu", "eye.cu")
#: The kernels line's rows, each a ``CudaKernel``'s name (``ops/cuda_build.KERNELS``).
KERNEL_ROWS = ("newton", "deposit_tile", "deposit_lane", "deposit_lane_bwd",
               "deposit_block", "deposit_stream", "walk_refill", "walk_compact", "walk_bezier",
               "walk_shade", "eye_hit", "eye_bezier", "eye_shade")


def zero_counters() -> None:
    from raytrace3_tpu_torch.ops.cuda_build import zero_launches

    zero_launches()


def read_counters() -> dict:
    """Each kernel's launches by its row's name (0 for a kernel whose
    module this process never imported)."""
    from raytrace3_tpu_torch.ops.cuda_build import launch_counts

    counts = launch_counts()
    return {name: counts.get(name, 0) for name in KERNEL_ROWS}


def compare_deposit(got, want) -> tuple[int, float, float]:
    """(count mismatches, max relative flux error, max |got - want|)."""
    cnt_mismatch = int((got[:, 0] != want[:, 0]).sum())
    dflux = (got[:, 1:4] - want[:, 1:4]).abs()
    rel = float((dflux / want[:, 1:4].abs().clamp_min(1e-6)).max())
    return cnt_mismatch, rel, float((got - want).abs().max())


def compare_deposit_witnessed(phase: int, got, plain, witness) -> tuple[int, float, float]:
    """``compare_deposit`` of the kernel's ``got`` against the float64-summed
    twin ``witness``; prints that and the float32 twin ``plain``'s distances
    (from the kernel and from the witness)."""
    cnt_mismatch, rel, err = compare_deposit(got, witness)
    _, rel_plain, _ = compare_deposit(got, plain)
    _, rel_twin, _ = compare_deposit(plain, witness)
    print(f"[{phase}] count mismatches {cnt_mismatch}; max relative flux error against the "
          f"float64-summed twin {rel:.3g} (max |d out| {err:.3g}); against the float32 twin "
          f"{rel_plain:.3g}, which sits {rel_twin:.3g} from the float64-summed one")
    return cnt_mismatch, rel, err


def print_geometry(phase: int, geom, lanes: torch.Tensor, row: dict, card: str) -> None:
    """A deposit kernel's launch geometry, lanes per tile and time against
    its bound and its instruction floor: under -fmad=false no multiply-add
    fuses, so the card's 67 TFLOP/s (an FMA counted as two operations)
    executes half the operations the bound assumes."""
    lanes = lanes.double()
    print(f"[{phase}] launch geometry: {geom.threads} threads a block = {geom.slot_threads} "
          f"slot threads x {geom.splits} lane splits, {geom.gsplits} block(s) a tile, "
          f"{geom.shared_bytes} B shared; lanes per tile max {int(lanes.max())}, mean "
          f"{float(lanes.mean()):.0f} over {lanes.numel()} tiles")
    print(f"[{phase}] kernel {row['ms']:.3f} ms = {row['ms'] / row['bound_ms']:.2f}x its bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}), {row['ms'] / (2 * row['bound_ms']):.2f}x "
          f"the instruction floor {2 * row['bound_ms']:.3f} ms ({card})")


def timed_once(fn):
    """(result, device ms) of one call of ``fn``, by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_build(card: str) -> None:
    from raytrace3_tpu_torch.ops import cuda_build

    def one(source):
        t0 = time.perf_counter()
        return source, cuda_build.build(source), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(one, SOURCES))
    for source, lib, secs in built:
        print(f"[1] built {source} in {secs:.1f} s -> {lib.name}")
        for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    print(f"[1] all {len(SOURCES)} sources built in {time.perf_counter() - t0:.1f} s; card: {card}")


def phase_newton(card: str, device) -> dict:
    """Kernel vs plain on the Newton inputs of one photon segment."""
    from raytrace3_tpu_torch.ops.newton_kernel import (RAYS_PER_BLOCK, drain_schedule,
                                                       open_pairs, solve, solve_plain)
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.photon import photon_trace_regen
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**BENCH)
    scene = build_scene(cfg, device).replace(
        bezier_compact_frac=cfg.bezier_compact_frac_photon)
    calls = []

    def recording(org, dir, ctrl):
        calls.append((org.clone(), dir.clone(), ctrl))
        return solve(org, dir, ctrl, cfg.newton_iters, RESTARTS)

    gen = torch.Generator(device=device).manual_seed(1)
    deps, _, _ = photon_trace_regen(scene, gen, scene.light_pos, scene.light_color,
                                    cfg.photons_per_round, None, cfg.max_depth,
                                    newton_fn=recording)
    org, dir, ctrl = calls[3]          # segment 3: origins spread over the room
    got = solve(org, dir, ctrl, cfg.newton_iters, RESTARTS)
    want = solve_plain(org, dir, ctrl, cfg.newton_iters, RESTARTS)
    hit_g, hit_w = got[4], want[4]
    both = hit_g & hit_w
    mismatch = int((hit_g != hit_w).sum())
    pid_mismatch = int((both & (got[3] != want[3])).sum())
    err = max(float((g - w)[both].abs().max()) if bool(both.any()) else 0.0
              for g, w in zip(got[:3], want[:3]))
    times = kernel_times(lambda: solve(org, dir, ctrl, cfg.newton_iters, RESTARTS))
    plain_ms = cuda_ms(lambda: solve_plain(org, dir, ctrl, cfg.newton_iters, RESTARTS), 3)
    print(f"[2] newton: {org.shape[0]} rays x {ctrl.shape[0]} patches x {RESTARTS} restarts; "
          f"hits {int(hit_w.sum())}, hit mismatches {mismatch}, pid mismatches "
          f"{pid_mismatch}, max |dt, du, dv| on common hits {err:.3g}")
    print(f"[2] newton: kernel {times[0]:.4f} ms device, {times[1]:.4f} ms a call, plain "
          f"{plain_ms:.3f} ms ({card})")
    # The solver the port takes without --pallas: not a kernel, timed for
    # the record beside it.
    from raytrace3_tpu_torch.geometry.bezier import solve_winner

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    winner_ms = cuda_ms(lambda: solve_winner(org, dir, ctrl, cfg.newton_iters), 3)
    extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"[2] default solver (geometry.bezier.solve_winner, plain PyTorch, 4 x 4 starts) "
          f"on the same rays: {winner_ms:.3f} ms, {extra_gb:.3f} GB above the inputs ({card})")
    if mismatch or pid_mismatch or not err <= NEWTON_ATOL or int(hit_w.sum()) == 0:
        raise SystemExit("phase 2 failed: the Newton kernel disagrees with its plain twin")
    R, B = org.shape[0], ctrl.shape[0]
    gate = open_pairs(org, dir, ctrl)
    open_lanes = int(gate.sum()) * RESTARTS
    sched = drain_schedule(gate, RESTARTS)
    lane_ops = open_lanes * (NEWTON_START_OPS + cfg.newton_iters * NEWTON_ITER_OPS)
    ops = B * NEWTON_BOX_OPS + R * NEWTON_RAY_OPS + R * B * NEWTON_PAIR_OPS + lane_ops
    ops_v1 = (R * B * RESTARTS * NEWTON_V1_GATE_OPS + open_lanes
              * (NEWTON_START_OPS + cfg.newton_iters * NEWTON_V1_ITER_OPS))
    nbytes = R * 24 + B * 48 * 4 + R * 17
    print(f"[2] newton: {open_lanes} of {R * B * RESTARTS} lanes pass the patch box "
          f"({int(gate.sum())} of {R * B} (ray, patch) pairs); {RAYS_PER_BLOCK} rays a block, "
          f"{sched['blocks']} blocks ({sched['blocks_without_newton']} run no Newton), "
          f"{sched['drains']} queue drains in {sched['steps']} Newton steps, "
          f"{sched['lane_fill']:.3f} of their lanes open")
    row = kernel_row("newton", "newton.cu", "raytrace3_tpu/ops/newton_pallas.py:122",
                     err, times, plain_ms, ops, nbytes)
    v1_ms, _ = bound(ops_v1, nbytes)
    print(f"[2] newton: {ops / 1e9:.4f} G fp32 operations, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}); the first version's count (every lane gated) "
          f"{ops_v1 / 1e9:.4f} G, bound {v1_ms:.5f} ms; kernel at "
          f"{row['ms'] / row['bound_ms']:.1f}x the bound ({card})")
    row["_round"] = deps
    return row


def walk_differences(got, want) -> dict:
    """Lanes where two segments' (carry, record) differ, by field (NaN
    equal to NaN; ``rr_off`` and ``emitted`` as elements)."""
    names = ("pos", "dir", "flux", "alive", "depth", "rr_off", "emitted", "record pos",
             "record n", "record flux", "record valid")
    out = {}
    for name, g, w in zip(names, got[0] + got[1], want[0] + want[1]):
        ne = g != w
        if g.is_floating_point():
            ne &= ~(torch.isnan(g) & torch.isnan(w))
        out[name] = int(ne.reshape(ne.shape[0], -1).any(1).sum()) if ne.dim() else int(ne)
    return out


def phase_walk(card: str, device) -> tuple:
    """Phase 24: the regen walk's kernels (``ops/walk_kernel``) against
    their plain twin (``photon.regen_segment_plain``) on the main path's
    round at each of WALK_LANES lanes: 14 segments, each from the twin's
    carry on the same draws (the five uniforms ``regen_segment`` draws,
    from one generator), through the Newton kernel on both sides; every
    lane of the carry and the record bit for bit.  Then the three kernels'
    device times on segment WALK_TIMED_SEGMENT beside their byte bounds
    (``walk_kernel.kernel_bytes``; their operations, a few hundred a lane,
    take under a tenth of that), the segment's least time
    (``segment_bytes``) and the whole segment through the kernels and
    through the twin.  Returns the kernels line's three rows (the render
    round's)."""
    from raytrace3_tpu_torch.core.sampling import TWO_PI, GeneratorDraws
    from raytrace3_tpu_torch.ops import walk_kernel
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render import photon
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**BENCH)
    scene = build_scene(cfg, device).replace(
        bezier_compact_frac=cfg.bezier_compact_frac_photon)
    newton = make_newton(cfg.newton_iters, RESTARTS)
    fetch = photon._material_lanes(scene)
    lp, lc = scene.light_pos, scene.light_color
    L, segs, debias = lp.shape[0], cfg.max_depth + 1, cfg.debias_roulette
    replaces = "none: the XLA-fused segment of raytrace3_tpu/render/photon.py, regen_segment"
    rows = None
    for n in WALK_LANES:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(24))
        carry = photon.regen_state_init(L, n // L, device) + (
            torch.zeros((L,), dtype=torch.float32, device=device),)
        ws = walk_kernel.kernel_tables(scene, fetch.table, lp, lc, carry)
        if ws is None:
            raise SystemExit("phase 24 failed: the walk kernels were not picked on the card")
        segment = lambda uni, carry: ws.run(
            walk_kernel.SegmentLanes(ws, uni, carry, segs, debias), newton)
        bad, deposits = {}, 0
        compacts = walk_kernel.COMPACT.launches
        for k in range(segs):
            uni = (draws.uniform((n,), -1.0, 1.0), draws.uniform((n,), 0.0, TWO_PI),
                   draws.uniform((n,)), draws.uniform((n,)), draws.uniform((n,)))
            got = segment(uni, carry)
            want = photon.regen_segment_plain(scene, fetch, uni, lp, lc, carry, segs, debias,
                                              newton)
            for f, v in walk_differences(got, want).items():
                bad[f] = bad.get(f, 0) + v
            deposits += int(want[1][3].sum())
            if k == WALK_TIMED_SEGMENT:
                timed = (uni, carry)
            carry = want[0]
        per_seg = (walk_kernel.COMPACT.launches - compacts) / segs
        print(f"[24] walk, {n} lanes x {segs} segments, kernels against the plain twin from "
              f"the twin's carry: lanes that differ {bad}; deposits {deposits}; walk_compact "
              f"launches a segment {per_seg}")
        if any(bad.values()) or deposits < n or per_seg != 1.0:
            raise SystemExit("phase 24 failed: the walk kernels disagree with their plain twin")
        uni, carry = timed
        w = walk_kernel.SegmentLanes(ws, uni, carry, segs, debias)
        times, rays, solved = segment_kernel_times(ws, w, newton)
        compact_ms = compaction_against_twin(24, ws, w)
        seg_ms = cuda_ms(lambda: segment(uni, carry), 5)
        plain_ms = cuda_ms(lambda: photon.regen_segment_plain(
            scene, fetch, uni, lp, lc, carry, segs, debias, newton), 3)
        nbytes = walk_kernel.kernel_bytes(n, rays, solved, L)
        here = {name: kernel_row(name, "walk.cu", *(
            (COMPACT_REPLACES, 0.0, times[name], compact_ms) if name == walk_kernel.COMPACT.name
            else (replaces, 0.0, times[name], plain_ms)), 0, nbytes[name]) for name in times}
        least_ms, _ = bound(0, walk_kernel.segment_bytes(n, L))
        three = sum(r["ms"] for k, r in here.items() if k != walk_kernel.COMPACT.name)
        print(f"[24] walk, {n} lanes, segment {WALK_TIMED_SEGMENT} ({solved} of {rays} "
              f"compacted slots hold a ray): " + "; ".join(
                  f"{k} {r['ms'] * 1e3:.2f} us device, {r['call_ms'] * 1e3:.1f} us a call, "
                  f"bound {r['bound_ms'] * 1e3:.2f} us ({r['ms'] / r['bound_ms']:.2f}x)"
                  for k, r in here.items()) + f" ({card})")
        print(f"[24] walk, {n} lanes: the three {three * 1e3:.2f} us = {three / least_ms:.2f}x "
              f"the segment's least time {least_ms * 1e3:.2f} us "
              f"({walk_kernel.segment_bytes(n, L) / n:.0f} bytes a lane); a segment through "
              f"the kernels {seg_ms:.3f} ms, through the twin {plain_ms:.3f} ms ({card})")
        rows = rows or here
    return tuple(rows.values())


#: What ``walk_compact`` stands beside in the JAX package (it replaces no TPU kernel).
COMPACT_REPLACES = "none: the sort and gathers of raytrace3_tpu/ops/compact.py, compact_indices"


def segment_kernel_times(tables, w, newton) -> tuple:
    """({kernel name: kernel_times}, Bezier slots, slots that hold a ray) of
    one segment's kernels on ``w`` (a ``walk_kernel.Segment``): its first
    kernel, the middle's compaction, the row kernel on ``tables.solve``'s
    winners, its shade."""
    from raytrace3_tpu_torch.ops import walk_kernel

    first, rows, shade = w.KERNELS
    w.launch(first)
    idx, d_c, hits = tables.solve(w, newton)
    rays = hits[0].shape[0]
    solved = rays if idx is None else int((idx < w.rays[0].shape[0]).sum())
    bez = lambda: walk_kernel.bezier_rows(w.rows, idx, d_c, *hits, tables.ctrl, kernel=rows)
    times = {first.name: kernel_times(lambda: w.launch(first))}
    if idx is not None:
        times[walk_kernel.COMPACT.name] = kernel_times(lambda: tables.compact(w))
    times.update({rows.name: kernel_times(bez), shade.name: kernel_times(lambda: w.launch(shade))})
    return times, rays, solved


def compaction_against_twin(phase: int, tables, w) -> float:
    """Hold ``tables.compact(w)``'s outputs (``w``'s first kernel run) bit
    for bit to its plain twin's, ``bezier.compact_rays`` (the sort and
    gathers of ``bezier.solve_gated``), and its gated count to the twin's;
    print both times a middle and return the twin's call ms."""
    from raytrace3_tpu_torch.geometry.bezier import compact_rays
    from raytrace3_tpu_torch.ops import walk_kernel

    org, dir = w.rays
    R = org.shape[0]
    idx, org_c, dir_c, _, total = tables.compact(w)
    cap = idx.shape[0]
    twin = lambda: compact_rays(org, dir, w.gate, cap)
    i, o_c, d_c, key = twin()
    gated = int(torch.searchsorted(key, torch.ones(1, dtype=key.dtype, device=key.device)))
    same = (torch.equal(idx, i) and torch.equal(org_c, o_c) and torch.equal(dir_c, d_c)
            and int(total) == gated)
    ms, call_ms = kernel_times(lambda: tables.compact(w))
    plain_ms = cuda_ms(twin, 5)
    least_ms, _ = bound(0, walk_kernel.compact_bytes(R, cap, min(gated, cap)))
    print(f"[{phase}] walk_compact, {R} lanes into {cap} slots ({gated} gated): bit for bit the "
          f"twin's {same}; {ms * 1e3:.2f} us device a middle, {call_ms * 1e3:.1f} us a call, "
          f"least {least_ms * 1e3:.2f} us ({ms / least_ms:.2f}x); the twin's sort and gathers "
          f"{plain_ms * 1e3:.1f} us a call")
    if not same:
        raise SystemExit(f"phase {phase} failed: walk_compact disagrees with its plain twin")
    return plain_ms


def eye_differences(got, want) -> dict:
    """Lanes where two eye segments' (next lanes, dropped, rows) differ, by
    field (NaN equal to NaN; ``dropped`` as the scalar)."""
    names = ("pos", "dir", "weight", "pixel", "active", "rows")
    out = {}
    for name, g, w in zip(names, got[0] + (got[2],), want[0] + (want[2],)):
        ne = g != w
        if g.is_floating_point():
            ne &= ~(torch.isnan(g) & torch.isnan(w))
        out[name] = int(ne.reshape(ne.shape[0], -1).any(1).sum())
    out["dropped"] = int(got[1] != want[1])
    return out


def phase_eye(card: str, device) -> tuple:
    """Phase 25: the staged eye's kernels (``ops/eye_kernel``) against their
    plain twin (``eye.eye_segment_plain``) on the bench's own eye pass
    (its 262,144 camera rays, its grown staged schedule, the Newton kernel
    on both sides): each segment runs on the same lanes through both, the
    twin's output goes on through the pass's compactions; every lane bit
    for bit.  Then the three kernels' device times on segment
    EYE_TIMED_SEGMENT beside their byte bounds (``eye_kernel
    .eye_kernel_bytes``), the segment's least time (``eye_segment_bytes``)
    and the whole segment through the kernels and through the twin.
    Returns the kernels line's three rows."""
    from raytrace3_tpu_torch.ops import eye_kernel, walk_kernel
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render import eye

    cfg, scene, org, dir = bench_eye_rays(device)
    newton = make_newton(cfg.newton_iters, RESTARTS)
    real, plain, pairs = eye.eye_segment, eye.eye_segment_plain, []

    def both(scene_, fetch, lanes, newton_fn=None, slots=1, eye=None):
        got = real(scene_, fetch, lanes, newton_fn, slots, eye=eye)
        want = plain(scene_, fetch, lanes, newton_fn, slots)
        pairs.append((lanes, got, want, eye))
        return want

    eye.eye_segment = both
    try:
        _, st = eye.eye_pass(scene, org, dir, cfg.hitpoint_capacity, cfg.max_depth, 1,
                             cfg.init_r2, newton_fn=newton,
                             compact_schedule=cfg.eye_compact_schedule)
    finally:
        eye.eye_segment = real
    torch.cuda.synchronize()
    bad, rows = {}, 0
    for _, got, want, _ in pairs:
        for f, v in eye_differences(got, want).items():
            bad[f] = bad.get(f, 0) + v
        rows += int((want[2][:, 10] > 0.5).sum())
    widths = [p[0][0].shape[0] for p in pairs]
    print(f"[25] eye, {org.shape[0]} camera rays x {len(pairs)} segments (lanes "
          f"{sorted(set(widths), reverse=True)}, {st['eye_grown_lanes']} grown), kernels "
          f"against the plain twin on the same lanes: lanes that differ {bad}; hit-point rows "
          f"{rows}; kernel segments {st['eye_kernel_segments']}")
    if (any(bad.values()) or len(pairs) != cfg.max_depth + 1 or rows < org.shape[0] // 2
            or st["eye_kernel_segments"] != len(pairs)):
        raise SystemExit("phase 25 failed: the eye kernels disagree with their plain twin")
    lanes, _, _, es = pairs[EYE_TIMED_SEGMENT]
    n = lanes[0].shape[0]
    w = eye_kernel.SegmentLanes(es, lanes)
    times, rays, solved = segment_kernel_times(es, w, newton)
    times.pop(walk_kernel.COMPACT.name)
    compaction_against_twin(25, es, w)
    fetch = eye._eye_material_lanes(scene)
    seg_ms = cuda_ms(lambda: es.run(eye_kernel.SegmentLanes(es, lanes), newton), 5)
    plain_ms = cuda_ms(lambda: plain(scene, fetch, lanes, newton), 3)
    nbytes = eye_kernel.eye_kernel_bytes(n, rays, solved)
    replaces = "none: the XLA-fused segment of raytrace3_tpu/render/eye.py, eye_segment"
    here = {name: kernel_row(name, "walk.cu" if name == "eye_bezier" else "eye.cu", replaces,
                             0.0, times[name], plain_ms, 0, nbytes[name]) for name in times}
    least_ms, _ = bound(0, eye_kernel.eye_segment_bytes(n))
    three = sum(r["ms"] for r in here.values())
    print(f"[25] eye, {n} lanes, segment {EYE_TIMED_SEGMENT} ({solved} of {rays} compacted "
          f"slots hold a ray): " + "; ".join(
              f"{k} {r['ms'] * 1e3:.2f} us device, {r['call_ms'] * 1e3:.1f} us a call, "
              f"bound {r['bound_ms'] * 1e3:.2f} us ({r['ms'] / r['bound_ms']:.2f}x)"
              for k, r in here.items()) + f" ({card})")
    print(f"[25] eye, {n} lanes: the three {three * 1e3:.2f} us = {three / least_ms:.2f}x the "
          f"segment's least time {least_ms * 1e3:.2f} us "
          f"({eye_kernel.eye_segment_bytes(n) / n:.0f} bytes a lane); a segment through the "
          f"kernels {seg_ms:.3f} ms, through the twin {plain_ms:.3f} ms ({card})")
    return tuple(here.values())


def bench_eye_rays(device):
    """(cfg, scene, org, dir): the bench's scene and its 512^2 camera rays."""
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**BENCH)
    scene = build_scene(cfg, device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    org, dir = emit_rays(look_at(f32(BASE), f32(LOOK), cfg.width, cfg.height))
    return cfg, scene, org, dir


def bench_hitpoints(device):
    """(cfg, scene, hit points, eye stats) of the bench's 512^2 eye pass."""
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.eye import eye_pass

    cfg, scene, org, dir = bench_eye_rays(device)
    hp, st = eye_pass(scene, org, dir, cfg.hitpoint_capacity, cfg.max_depth, 1,
                      cfg.init_r2, newton_fn=make_newton(cfg.newton_iters, RESTARTS),
                      compact_schedule=cfg.eye_compact_schedule)
    return cfg, scene, hp, st


def phase_deposit(card: str, device, deps) -> dict:
    """Kernel vs plain on one bench round against the 512^2 layout."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (deposit_geometry, deposit_tile,
                                                        deposit_tile_plain,
                                                        make_tile_deposit,
                                                        world_bounds_from_scene)

    cfg, scene, hp, st = bench_hitpoints(device)
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    dep_fn = make_tile_deposit(tile=TILE, **{k: b[k] for k in BOUNDS})
    prep = dep_fn.prepare(hp)
    r2_pad, _ = dep_fn.pack_state(hp, prep)
    packed = prep.packed.clone()
    packed[:, 6] = r2_pad
    n_tiles = packed.shape[0] // TILE
    dkeys, dep_packed, _ = dep_fn._dep_sorted(deps, dep_fn.chunk)
    sk, ek = dep_fn._window_lanes(prep, dkeys, n_tiles)
    sk, ek = sk.to(torch.int32).contiguous(), ek.to(torch.int32).contiguous()

    got = deposit_tile(sk, ek, packed, dep_packed)
    want = deposit_tile_plain(sk, ek, packed, dep_packed)
    want64 = deposit_tile_plain(sk, ek, packed, dep_packed, sum_dtype=torch.float64)
    pairs = int((ek - sk).sum()) * TILE
    times = kernel_times(lambda: deposit_tile(sk, ek, packed, dep_packed))
    plain_ms = cuda_ms(lambda: deposit_tile_plain(sk, ek, packed, dep_packed), 3)
    print(f"[3] deposit: {int(deps.valid.sum())} valid of {deps.pos.shape[0]} deposits, "
          f"{int(st['count'])} hit points in {n_tiles} tiles of {TILE}, "
          f"{pairs / 1e9:.3f} G pair tests; pairs found {int(want[:, 0].sum())}")
    cnt_mismatch, rel, err = compare_deposit_witnessed(3, got, want, want64)
    print(f"[3] deposit: kernel {times[0]:.3f} ms device, {times[1]:.3f} ms a call, plain "
          f"{plain_ms:.3f} ms ({card})")
    if cnt_mismatch or not rel <= DEPOSIT_FLUX_RTOL or int(want[:, 0].sum()) == 0:
        raise SystemExit("phase 3 failed: the deposit kernel disagrees with its plain twin")
    taken = float(want[:, 0].sum())
    c_pad, Dp = packed.shape[0], dep_packed.shape[1]
    nbytes = 9 * Dp * 4 + 2 * c_pad * 8 * 4 + 2 * sk.numel() * 4
    row = kernel_row("deposit_tile", "deposit_tile.cu",
                     "raytrace3_tpu/ops/deposit_pallas.py:862", err, times, plain_ms,
                     PAIR_OPS * pairs + TAKEN_OPS_FWD * taken, nbytes)
    print_geometry(3, deposit_geometry(TILE), (ek - sk).clamp_min(0).sum(1), row, card)
    return row


def phase_small(device) -> None:
    """A 32 x 32 pass on the card held to the CPU's, same draws."""
    from raytrace3_tpu_torch.core.sampling import (GeneratorDraws, RecordingDraws,
                                                   ReplayDraws)
    from raytrace3_tpu_torch.testing import (MAX_FLIPS, pinned_segments,
                                             recording_segments)

    small = dict(BENCH, width=32, height=32, rounds=2, photons_per_round=1024,
                 atlas_res=32)
    draws = RecordingDraws(GeneratorDraws(torch.Generator().manual_seed(0)))
    _, _, fn_cpu = make_pass(small, "cpu")
    with recording_segments() as steps:
        img_c, st_c = fn_cpu(draws)
    _, _, fn_gpu = make_pass(small, device)
    with pinned_segments(steps["eye"], steps["photon"]) as report:
        img_g, st_g = fn_gpu(ReplayDraws(draws.arrays, device=device))
    img_g, img_c = img_g.cpu().numpy(), img_c.numpy()
    st_g = {k: float(v) for k, v in st_g.items()}
    st_c = {k: float(v) for k, v in st_c.items()}
    l1 = float(np.abs(img_g - img_c).sum() / np.abs(img_c).sum())
    print(f"[4] small pass card vs cpu, held segment by segment: {report.segments} "
          f"segments, lanes per class {report.lanes}")
    print("[4] largest deviation per field: " + ", ".join(
        f"{k} {v:.3g}" for k, v in sorted(report.max_err.items())))
    print(f"[4] stats card {st_g}\n[4] stats cpu  {st_c}\n[4] image relative L1 {l1:.3g}")
    ok = (report.segments == {"eye": len(steps["eye"]), "photon": len(steps["photon"])}
          and report.lanes["self-hit flip"] <= MAX_FLIPS
          and all(st_g[k] == st_c[k] for k in
                  ("count", "dropped", "deposits_dropped", "photons_emitted"))
          and np.isfinite(img_g).all() and st_c["count"] > 900 and l1 <= SMALL_L1_RTOL)
    if not ok:
        raise SystemExit("phase 4 failed: the card's pass disagrees with the CPU's")


def phase_main(card: str, device) -> dict:
    """The main path: the port bench's measurement at its defaults; returns
    launch counts."""
    zero_counters()
    record, img = bench_torch.measure(bench_torch.knobs({}))
    launches = read_counters()
    print(f"[5] bench_torch record: {json.dumps(record)}")
    print(f"[5] main path {record['pass_seconds']:.3f} s/pass, {record['value']:.0f} photons/s, "
          f"{record['mrays_per_s']:.2f} Mrays/s, first pass {record['compile_seconds']} s; "
          f"launches {launches} ({card})")
    ok = (record["deposits_dropped"] == 0 and record["eye_dropped"] == 0
          and record["hitpoints"] > 0 and record["backend"] == "cuda"
          and record["pallas_newton"] and record["card"] == card
          and tuple(img.shape) == (512, 512, 3)
          and bool(torch.isfinite(img).all()) and float(img.mean()) > 0
          and launches["newton"] > 0 and launches["deposit_tile"] > 0
          and all(launches[k] > 0 for k in ("walk_refill", "walk_bezier", "walk_shade",
                                            "eye_hit", "eye_bezier", "eye_shade")))
    if not ok:
        raise SystemExit("phase 5 failed: the main path's result or launches are wrong")
    return launches


def train_round(device):
    """The train path's inputs to its deposit: the slot eye pass and one
    static-walk round at the train configuration, on the card, and the
    deposit ``make_train_step`` picks there."""
    from raytrace3_tpu_torch.diff.train import default_deposit_vjp
    from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.eye import eye_pass
    from raytrace3_tpu_torch.render.light import emit_photons
    from raytrace3_tpu_torch.render.photon import photon_trace
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**TRAIN)
    scene = build_scene(cfg, device)
    newton = make_newton(cfg.newton_iters, RESTARTS)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    org, dir = emit_rays(look_at(f32(BASE), f32(LOOK), cfg.width, cfg.height))
    hp, st = eye_pass(scene, org, dir, cfg.hitpoint_capacity, cfg.max_depth, 1,
                      cfg.init_r2, newton_fn=newton)
    gen = torch.Generator(device=device).manual_seed(2)
    o, d, f = emit_photons(gen, scene.light_pos, scene.light_color, cfg.photons_per_round)
    deps = photon_trace(scene, gen, o, d, f, cfg.max_depth, newton_fn=newton)
    depo = default_deposit_vjp(scene, cfg)
    if not (isinstance(depo, DepositLane) and depo.differentiable):
        raise SystemExit(f"the train path picked {depo!r}, not the differentiable lane deposit")
    prep = depo.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    n_tiles = packed.shape[0] // depo.tile
    dkeys, dep_packed, Dp = depo._dep_sorted(deps, depo.chunk)
    sk, ek = depo._window_lanes(prep, dkeys, n_tiles)
    return dict(depo=depo, prep=prep, packed=packed, dep_packed=dep_packed, sk=sk, ek=ek,
                n_tiles=n_tiles, Dp=Dp, deps=deps, hp_count=int(st["count"]))


def print_parts(phase: int, what: str, lo, hi, lanes, per_block: int, n_items: int,
                geometry: str) -> None:
    """A lane kernel's launch: its runs cut into parts of ``per_block``
    items (one block a part), items per run and lanes per item."""
    from raytrace3_tpu_torch.ops.lane_kernel import run_parts

    runs = (hi - lo).double()
    parts = int(run_parts(lo, hi, per_block, n_items)[1][-1])
    lanes = lanes.double()
    print(f"[{phase}] launch geometry: {geometry}; {parts} blocks, one a part of at most "
          f"{per_block} items; items per {what} max {int(runs.max())}, mean "
          f"{float(runs.mean()):.2f} over {runs.numel()}; lanes per item max "
          f"{int(lanes.max())}, mean {float(lanes.mean()):.1f}")


def phase_lane(card: str, r: dict) -> dict:
    """Kernel #3 vs its plain twin on one train round."""
    from raytrace3_tpu_torch.ops.deposit_kernel import deposit_geometry
    from raytrace3_tpu_torch.ops.lane_kernel import (LANE_GRID_SPLITS, LANE_ITEMS_PER_BLOCK,
                                                     deposit_lane, deposit_lane_plain)

    depo, packed, dep_packed = r["depo"], r["packed"], r["dep_packed"]
    lo, hi, wa, wb, overflow = depo.forward_items(r["sk"], r["ek"], r["n_tiles"], r["Dp"])
    got = deposit_lane(lo, hi, wa, wb, packed, dep_packed)
    want = deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed)
    want64 = deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed, sum_dtype=torch.float64)
    items = int(hi.max())
    pairs = int((wb - wa)[:items].sum()) * depo.tile
    taken = float(want[:, 0].sum())
    _, _, _, _, _, _, total = depo._build_items(r["sk"], r["ek"], r["n_tiles"], depo.work_cap,
                                                r["Dp"], 128)
    _, _, kernel_overflow = depo._kernel_call(packed, r["deps"], r["prep"])
    times = kernel_times(lambda: deposit_lane(lo, hi, wa, wb, packed, dep_packed))
    plain_ms = cuda_ms(lambda: deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed), 3)
    print(f"[6] lane deposit: {int(r['deps'].valid.sum())} valid of {r['deps'].pos.shape[0]} "
          f"deposits, {r['hp_count']} hit points in {r['n_tiles']} tiles of {depo.tile}; "
          f"{items} work items of {depo.work_cap} (of {int(total)} needed), "
          f"{pairs / 1e9:.3f} G pair tests; pairs found {int(taken)}")
    cnt_mismatch, rel, err = compare_deposit_witnessed(6, got, want, want64)
    print(f"[6] lane deposit: overflow {int(overflow)} / kernel path {int(kernel_overflow)}")
    print(f"[6] lane deposit: kernel {times[0]:.3f} ms device, {times[1]:.3f} ms a call, "
          f"plain {plain_ms:.3f} ms ({card})")
    if (cnt_mismatch or not rel <= DEPOSIT_FLUX_RTOL or taken == 0
            or int(overflow) != int(kernel_overflow) or int(overflow) != 0):
        raise SystemExit("phase 6 failed: the lane deposit kernel disagrees with its plain twin")
    c_pad, Dp, W = packed.shape[0], dep_packed.shape[1], wa.shape[0]
    nbytes = 9 * Dp * 4 + 2 * c_pad * 8 * 4 + 2 * W * 4 + 2 * r["n_tiles"] * 4
    row = kernel_row("deposit_lane", "deposit_lane.cu",
                     "raytrace3_tpu/ops/deposit_pallas.py:530", err, times, plain_ms,
                     PAIR_OPS * pairs + TAKEN_OPS_FWD * taken, nbytes)
    geom = deposit_geometry(depo.tile, LANE_GRID_SPLITS)
    print_parts(6, "tile", lo, hi, (wb - wa)[:items], LANE_ITEMS_PER_BLOCK, W,
                f"{geom.threads} threads a block = {geom.slot_threads} slot threads x "
                f"{geom.splits} lane splits, {geom.shared_bytes} B shared")
    print(f"[6] kernel {row['ms']:.3f} ms = {row['ms'] / row['bound_ms']:.2f}x its bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}) ({card})")
    row["_taken"] = taken
    return row


def phase_lane_bwd(card: str, r: dict, taken: float) -> dict:
    """Kernel #4 vs its plain twin on the same round, u ~ U(0, 1) seeded:
    held to the twin summed in float64, and two calls bit for bit."""
    from raytrace3_tpu_torch.ops.lane_kernel import (LANE_BWD_ITEMS_PER_BLOCK,
                                                     deposit_lane_bwd, deposit_lane_bwd_plain,
                                                     lane_bwd_geometry)

    depo, packed, dep_packed = r["depo"], r["packed"], r["dep_packed"]
    items = depo.backward_items(r["sk"], r["ek"], r["n_tiles"], r["Dp"])
    gen = torch.Generator(device=packed.device).manual_seed(4)
    u = torch.rand((packed.shape[0], 3), generator=gen, device=packed.device)
    args = (*items, packed, u, dep_packed, depo.tile)
    got = deposit_lane_bwd(*args, depo.chunk)
    again = deposit_lane_bwd(*args, depo.chunk)
    want = deposit_lane_bwd_plain(*args)
    want64 = deposit_lane_bwd_plain(*args, sum_dtype=torch.float64)
    relative = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())
    rel, rel_plain, rel_twin = relative(got, want64), relative(got, want), relative(want, want64)
    err = float((got - want64).abs().max())
    bitwise = bool(torch.equal(got, again))
    run_lo, run_hi, wt, wa, wb = items
    n_items = int(run_hi.max())
    pairs = int((wb - wa)[:n_items].sum()) * depo.tile
    times = kernel_times(lambda: deposit_lane_bwd(*args, depo.chunk))
    plain_ms = cuda_ms(lambda: deposit_lane_bwd_plain(*args), 3)
    print(f"[7] lane backward: {n_items} work items of {wt.shape[0]} over "
          f"{run_lo.shape[0]} deposit chunks of {depo.chunk}, {pairs / 1e9:.3f} G pair tests; "
          f"sum {float(want64.sum()):.6g}")
    print(f"[7] max relative error against the float64-summed twin {rel:.3g} (max |d| "
          f"{err:.3g}); against the float32 twin {rel_plain:.3g}, which sits {rel_twin:.3g} "
          f"from the float64-summed one; two calls bit for bit equal: {bitwise}")
    print(f"[7] lane backward: kernel {times[0]:.3f} ms device, {times[1]:.3f} ms a call, "
          f"plain {plain_ms:.3f} ms ({card})")
    if not rel <= DEPOSIT_FLUX_RTOL or float(want.sum()) <= 0 or not bitwise:
        raise SystemExit("phase 7 failed: the lane backward kernel disagrees with its plain "
                         "twin or with itself")
    geom = lane_bwd_geometry(depo.tile, depo.chunk)
    print_parts(7, "chunk", run_lo, run_hi, (wb - wa)[:n_items], LANE_BWD_ITEMS_PER_BLOCK,
                wt.shape[0], f"{geom.threads} threads a block, {geom.shared_bytes} B shared")
    c_pad, Dp, W = packed.shape[0], dep_packed.shape[1], wt.shape[0]
    nbytes = (6 * Dp * 4 + c_pad * 8 * 4 + c_pad * 3 * 4 + 3 * Dp * 4 + 3 * W * 4
              + 2 * run_lo.shape[0] * 4)
    row = kernel_row("deposit_lane_bwd", "deposit_lane_bwd.cu",
                     "raytrace3_tpu/ops/deposit_pallas.py:1243", err, times, plain_ms,
                     PAIR_OPS * pairs + TAKEN_OPS_BWD * taken, nbytes)
    print(f"[7] kernel {row['ms']:.3f} ms = {row['ms'] / row['bound_ms']:.2f}x its bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}) ({card})")
    return row


def small_train_step(device, draws, steps=None):
    """One small train step: (loss, stats, gradients, what was recorded or
    the holding's report)."""
    from raytrace3_tpu_torch.diff.train import adam, extract_params, make_train_step
    from raytrace3_tpu_torch.ops.deposit_kernel import world_bounds_from_scene
    from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.testing import pinned_segments, recording_segments
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**SMALL_TRAIN)
    scene = build_scene(cfg, device).replace(
        light_pos=torch.tensor(SMALL_LIGHT, dtype=torch.float32, device=device))
    dep = DepositLane(differentiable=True, **SMALL_LANE,
                      **world_bounds_from_scene(scene, extra_points=[SMALL_POSE[0]]))
    init_fn, step_fn = make_train_step(scene, cfg, adam(1e-2), SMALL_POSE,
                                       make_newton(cfg.newton_iters, RESTARTS), dep)
    params = extract_params(scene)
    opt = init_fn(params)
    target = torch.as_tensor(np.random.default_rng(3).uniform(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32), device=device)
    hold = recording_segments() if steps is None else pinned_segments(
        eye_steps=steps["eye"], static_steps=steps["static"])
    with hold as held:
        _, _, loss, stats = step_fn(params, opt, draws, target)
    grads = {k: v.grad.detach().cpu().numpy() for k, v in params.items()}
    return float(loss), {k: int(v) for k, v in stats.items()}, grads, held


def phase_small_train(device) -> None:
    """The card's small train step held to the CPU's, same draws."""
    from raytrace3_tpu_torch.core.sampling import (GeneratorDraws, RecordingDraws,
                                                   ReplayDraws)
    from raytrace3_tpu_torch.testing import MAX_FLIPS

    draws = RecordingDraws(GeneratorDraws(torch.Generator().manual_seed(1)))
    loss_c, st_c, g_c, steps = small_train_step("cpu", draws)
    loss_g, st_g, g_g, report = small_train_step(device, ReplayDraws(draws.arrays, device),
                                                 steps)
    errs = {k: float(np.abs(g_g[k] - g_c[k]).max() / max(np.abs(g_c[k]).max(), 1e-30))
            for k in g_c}
    print(f"[8] small train step card vs cpu, held: {report.segments} segments, "
          f"lanes per class {report.lanes}")
    print(f"[8] loss card {loss_g!r} cpu {loss_c!r}; stats card {st_g} cpu {st_c}")
    print("[8] max |grad| cpu: " + ", ".join(f"{k} {np.abs(v).max():.3g}" for k, v in g_c.items())
          + "; max |d grad| / max |grad|: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    ok = (report.segments == {"eye": len(steps["eye"]), "photon": 0,
                              "static": len(steps["static"])}
          and report.lanes["self-hit flip"] <= MAX_FLIPS and st_g == st_c
          and st_c == {"deposits_dropped": 0, "dropped": 0}
          and np.isfinite(loss_g) and abs(loss_g - loss_c) <= SMALL_LOSS_RTOL * abs(loss_c)
          and all(np.abs(g_c[k]).max() > 0 and np.isfinite(g_g[k]).all()
                  and errs[k] <= SMALL_GRAD_ATOL for k in g_c))
    if not ok:
        raise SystemExit("phase 8 failed: the card's train step disagrees with the CPU's")


def phase_train(card: str, device) -> dict:
    """The train path at full width; returns launch counts."""
    from raytrace3_tpu_torch.diff.train import (extract_params, make_render_fn,
                                                make_train_step)
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**TRAIN)
    scene = build_scene(cfg)                       # the card is the default
    newton = make_newton(cfg.newton_iters, RESTARTS)
    gen = lambda: torch.Generator(device=device).manual_seed(0)
    p_true = extract_params(scene)
    with torch.no_grad():
        target = make_render_fn(scene, cfg, newton_fn=newton)(p_true, gen())
    target = target.reshape(cfg.height, cfg.width, 3)
    params = dict(p_true, diff=p_true["diff"] * 0.5)
    init_fn, step_fn = make_train_step(scene, cfg, newton_fn=newton)
    opt = init_fn(params)
    zero_counters()
    losses, stats = [], []
    t0 = time.perf_counter()
    _, _, loss, st = step_fn(params, opt, gen(), target)
    losses.append(float(loss))
    stats.append({k: int(v) for k, v in st.items()})
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        _, _, loss, st = step_fn(params, opt, gen(), target)
        losses.append(loss)
        stats.append(st)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = read_counters()
    losses = [float(x) for x in losses]
    stats = [{k: int(v) for k, v in s.items()} for s in stats]
    grads = {k: v.grad for k, v in params.items()}
    gmax = {k: float(g.abs().max()) for k, g in grads.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    print(f"[9] train path {cfg.width}x{cfg.height}, {cfg.rounds} x {cfg.photons_per_round} "
          f"photons, C = {cfg.hitpoint_capacity}: first step {warm_s:.2f} s, "
          f"{step_s:.3f} s/step over {TIMED_STEPS}, peak memory {peak_gb:.2f} GB ({card})")
    print(f"[9] loss per step {losses}; stats {stats}")
    print(f"[9] max |grad| {gmax}; launches {launches}")
    train_kernels = ("newton", "deposit_lane", "deposit_lane_bwd")
    ok = (np.isfinite(losses).all() and losses[-1] < losses[0] and finite
          and all(s == {"deposits_dropped": 0, "dropped": 0} for s in stats)
          and all(v > 0 for v in gmax.values())
          and all(launches[k] > 0 for k in train_kernels))
    if not ok:
        raise SystemExit("phase 9 failed: the train path's result or launches are wrong")

    from raytrace3_tpu_torch.diff.train import load_optimizer_tree, optimizer_tree
    from raytrace3_tpu_torch.utils.checkpoint import flatten_tree, load_tree, save_tree

    live = {"params": params, "opt": optimizer_tree(opt, params)}
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    template = {"params": fresh, "opt": optimizer_tree(init_fn(fresh), fresh)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.npz")
        save_tree(path, live, step=1 + TIMED_STEPS)
        restored, step = load_tree(path, template)
    flat_l, flat_r = flatten_tree(live), flatten_tree(restored)
    same = [k for k, v in flat_l.items() if flat_r[k].device == v.device
            and flat_r[k].dtype == v.dtype and torch.equal(flat_r[k], v.detach())]
    load_optimizer_tree(init_fn(fresh), fresh, restored["opt"])
    print(f"[9] save_tree / load_tree of the params and Adam state on the card: "
          f"{len(same)} of {len(flat_l)} leaves bit for bit, step {step}")
    if len(same) != len(flat_l) or step != 1 + TIMED_STEPS:
        raise SystemExit("phase 9 failed: the train state did not restore bit for bit")
    return launches


def preset_round(device) -> dict:
    """The reference1024 preset's inputs to its deposit: the 1024^2 eye
    pass with its schedule and one regen round, on the card, and the
    deposit ``cli.py`` builds for it."""
    from raytrace3_tpu_torch import cli
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.eye import eye_pass
    from raytrace3_tpu_torch.render.photon import photon_trace_regen
    from raytrace3_tpu_torch.utils.config import get_config

    cfg = get_config("reference1024")
    scene = build_scene(cfg, device)
    newton, depo = cli.make_backends(cfg, scene)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    org, dir = emit_rays(look_at(f32(BASE), f32(LOOK), cfg.width, cfg.height))
    hp, st = eye_pass(scene, org, dir, cfg.hitpoint_capacity, cfg.max_depth, 1,
                      cfg.init_r2, newton_fn=newton, compact_schedule=cfg.eye_compact_schedule)
    photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
    gen = torch.Generator(device=device).manual_seed(3)
    deps, _, _ = photon_trace_regen(photon_scene, gen, scene.light_pos, scene.light_color,
                                    cfg.photons_per_round, None, cfg.max_depth,
                                    newton_fn=newton)
    return cfg, depo, hp, st, deps


def phase_block(card: str, device) -> dict:
    """Kernel #5 vs its plain twin on one reference1024 round."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (DepositBlock, deposit_block,
                                                        deposit_block_plain,
                                                        deposit_geometry)

    cfg, depo, hp, st, deps = preset_round(device)
    if not (isinstance(depo, DepositBlock) and depo.tile == 1024 and depo.work_cap == 65536):
        raise SystemExit(f"phase 10 failed: the CLI built {depo!r} for reference1024")
    prep = depo.prepare(hp)
    r2_pad, _ = depo.pack_state(hp, prep)
    packed = prep.packed.clone()
    packed[:, 6] = r2_pad
    n_tiles = packed.shape[0] // depo.tile
    dkeys, dep_packed, Dp = depo._dep_sorted(deps, depo.wchunk)
    wt, blk, wcmp, overflow, total = depo.work_list(prep, dkeys, n_tiles, Dp)
    args = (wt, blk, wcmp, packed, dep_packed, depo.tile, depo.wchunk)
    got = deposit_block(*args)
    want, plain_ms = timed_once(lambda: deposit_block_plain(*args))
    want64 = deposit_block_plain(*args, sum_dtype=torch.float64)
    computing = int(wcmp.sum())
    pairs = computing * depo.wchunk * depo.tile
    taken = float(want[:, 0].sum())
    times = kernel_times(lambda: deposit_block(*args))
    print(f"[10] block deposit at reference1024: {int(deps.valid.sum())} valid of "
          f"{deps.pos.shape[0]} deposits, {int(st['count'])} hit points (eye dropped "
          f"{int(st['dropped'])}) in {n_tiles} tiles of {depo.tile}; {int(total)} work "
          f"items needed of W = {depo.work_cap} ({computing} computing), overflow "
          f"{int(overflow)}; {pairs / 1e9:.3f} G pair tests, pairs taken {int(taken)}")
    cnt_mismatch, rel, err = compare_deposit_witnessed(10, got, want, want64)
    print(f"[10] block deposit: kernel {times[0]:.3f} ms device, {times[1]:.3f} ms a call, "
          f"plain {plain_ms:.3f} ms (one call) ({card})")
    if (cnt_mismatch or not rel <= DEPOSIT_FLUX_RTOL or taken == 0 or int(overflow) != 0
            or int(st["dropped"]) != 0):
        raise SystemExit("phase 10 failed: the block deposit kernel disagrees with its "
                         "plain twin, or the preset's round overflows")
    c_pad, W = packed.shape[0], wt.shape[0]
    nbytes = 9 * Dp * 4 + 2 * c_pad * 8 * 4 + 3 * W * 4
    row = kernel_row("deposit_block", "deposit_block.cu",
                     "raytrace3_tpu/ops/deposit_pallas.py:88", err, times, plain_ms,
                     PAIR_OPS * pairs + TAKEN_OPS_FWD * taken, nbytes)
    items = torch.bincount(wt.long()[wcmp != 0], minlength=n_tiles)
    print_geometry(10, deposit_geometry(depo.tile), items * depo.wchunk, row, card)
    return row


def png_size(path) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def phase_cli(card: str) -> dict:
    """The CLI at the reference1024 preset, then the card's resume check;
    returns the CLI run's launch counts."""
    from raytrace3_tpu_torch import cli
    from raytrace3_tpu_torch.utils import checkpoint
    from raytrace3_tpu_torch.utils.config import get_config

    with tempfile.TemporaryDirectory() as tmp:
        out, jl, ck = (os.path.join(tmp, n) for n in ("r.png", "m.jsonl", "ck.npz"))
        zero_counters()
        t0 = time.perf_counter()
        rc = cli.main(["--preset", "reference1024", "--passes", str(CLI_PASSES),
                       "--preview-every", "0", "--metrics-jsonl", jl, "--checkpoint", ck,
                       "--checkpoint-every", "1", "--out", out])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()
        recs = [json.loads(line) for line in open(jl)]
        size = png_size(out)
        saved = checkpoint.load(ck)
        for r in recs:
            print(f"[11] cli reference1024 pass {r['pass']}: {r['pass_seconds']:.3f} s, "
                  f"{r['photons_per_s']:.0f} photons/s, {r['mrays_per_s']:.2f} Mrays/s, "
                  f"hit points {r['hitpoints']}, dropped {r['dropped']}, deposits dropped "
                  f"{r['deposits_dropped']}, mean r2 {r['mean_r2']:.4f} ({card})")
        print(f"[11] cli: rc {rc}, {wall_s:.1f} s in all, PNG {size[0]}x{size[1]}, "
              f"checkpoint at pass {saved[1]}; launches {launches} ({card})")
        preset = get_config("reference1024")
        ok = (rc == 0 and len(recs) == CLI_PASSES and size == (preset.width, preset.height)
              and saved[1] == CLI_PASSES and np.isfinite(saved[0]).all()
              and float(saved[0].mean()) > 0
              and all(r["dropped"] == 0 and r["deposits_dropped"] == 0 and r["hitpoints"] > 0
                      for r in recs)
              and launches["newton"] > 0 and launches["deposit_block"] > 0)
        if not ok:
            raise SystemExit("phase 11 failed: the CLI's reference1024 render is wrong")

        straight, part = os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz")
        run = lambda passes, ck_path, every: cli.main(
            RESUME_ARGS + ["--passes", str(passes), "--checkpoint", ck_path,
                           "--checkpoint-every", str(every),
                           "--out", os.path.join(tmp, "s.png")])
        rcs = [run(3, straight, 0), run(1, part, 1), run(3, part, 1)]
        a, b = checkpoint.load(straight), checkpoint.load(part)
        l1 = float(np.abs(a[0] - b[0]).sum() / np.abs(a[0]).sum())
        print(f"[11] resume on the card, 64^2: 3 passes straight vs 1 + resume to 3: "
              f"rcs {rcs}, passes {a[1]} / {b[1]}, relative L1 {l1:.3g}")
        if rcs != [0, 0, 0] or not a[1] == b[1] == 3 or not l1 <= RESUME_L1_RTOL:
            raise SystemExit("phase 11 failed: the resumed render differs from the straight one")
    return launches


def phase_stream(card: str, device, deps) -> tuple[dict, dict]:
    """Kernel #6 vs its plain twin and DepositZTile vs DepositTile on the
    bench round, then one 512^2 pass with DepositStream; returns the
    kernel's row and the pass's launch counts."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (DepositZTile, deposit_geometry,
                                                        world_bounds_from_scene)
    from raytrace3_tpu_torch.ops.lane_kernel import (DepositStream, deposit_stream,
                                                     deposit_stream_plain, stream_mask)

    _, scene, hp, _ = bench_hitpoints(device)
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    xy = {k: b[k] for k in BOUNDS}
    depo = DepositStream(**STREAM, **xy)
    prep = depo.prepare(hp)
    r2_pad, _ = depo.pack_state(hp, prep)
    packed = prep.packed.clone()
    packed[:, 6] = r2_pad
    n_tiles = packed.shape[0] // depo.tile
    dkeys, dep_packed, Dp = depo._dep_sorted(deps, depo.chunk)
    sk, ek = depo._window_lanes(prep, dkeys, n_tiles)
    itf, itab, starts, ends, overflow = depo.stream_items(sk, ek, n_tiles, Dp)
    args = (itf, itab, starts, ends, packed, dep_packed)
    got = deposit_stream(*args)
    want, plain_ms = timed_once(lambda: deposit_stream_plain(*args))
    want64 = deposit_stream_plain(*args, sum_dtype=torch.float64)
    n_items = int(ends.max())
    wa, wb = stream_mask(itf, itab)
    lanes = (torch.clamp(wb, max=Dp) - torch.clamp(wa, min=0)).clamp_min(0)[:n_items]
    pairs = int(lanes.sum()) * depo.tile
    taken = float(want[:, 0].sum())
    times = kernel_times(lambda: deposit_stream(*args))
    print(f"[12] stream deposit on the bench round: {n_tiles} tiles of {depo.tile}, "
          f"{n_items} items of W = {depo.work_cap}, overflow {int(overflow)}; "
          f"{pairs / 1e9:.3f} G pair tests, pairs taken {int(taken)}")
    cnt_mismatch, rel, err = compare_deposit_witnessed(12, got, want, want64)
    print(f"[12] stream deposit: kernel {times[0]:.3f} ms device, {times[1]:.3f} ms a call, "
          f"plain {plain_ms:.3f} ms (one call) ({card})")
    if cnt_mismatch or not rel <= DEPOSIT_FLUX_RTOL or taken == 0 or int(overflow) != 0:
        raise SystemExit("phase 12 failed: the stream deposit kernel disagrees with its "
                         "plain twin")
    c_pad, W = packed.shape[0], itf.shape[0]
    nbytes = 9 * Dp * 4 + 2 * c_pad * 8 * 4 + 2 * W * 4 + 2 * n_tiles * 4
    row = kernel_row("deposit_stream", "deposit_stream.cu",
                     "raytrace3_tpu/ops/deposit_pallas.py:1106", err, times, plain_ms,
                     PAIR_OPS * pairs + TAKEN_OPS_FWD * taken, nbytes)
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=device),
                                      (ends - starts).long())
    per_tile = torch.zeros(n_tiles, dtype=torch.int64, device=device)
    per_tile.index_add_(0, tile_of, lanes.long())
    print_geometry(12, deposit_geometry(depo.tile), per_tile, row, card)

    # The coarse-z windows over the tile kernel take the tile deposit's pairs.
    from raytrace3_tpu_torch.ops.deposit_kernel import make_tile_deposit

    z_cnt, _, z_ovf = DepositZTile(**xy)(hp, deps)
    t_cnt, _, _ = make_tile_deposit(tile=TILE, **xy)(hp, deps)
    z_mismatch = int((z_cnt != t_cnt)[hp.valid].sum())
    print(f"[12] DepositZTile vs DepositTile on the bench round: count mismatches "
          f"{z_mismatch} of {int(hp.valid.sum())} hit points, overflow {int(z_ovf)}")
    if z_mismatch or int(z_ovf) != 0 or float(t_cnt.sum()) == 0:
        raise SystemExit("phase 12 failed: DepositZTile disagrees with DepositTile")

    _, _, fn = make_pass(BENCH, device, deposit=lambda xy_: DepositStream(**STREAM, **xy_))
    zero_counters()
    t0 = time.perf_counter()
    img, stats = fn(torch.Generator(device=device).manual_seed(4))
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    launches = read_counters()
    st = {k: float(v) for k, v in stats.items()}
    print(f"[12] one 512^2 pass with DepositStream: {pass_s:.3f} s, stats {st}, "
          f"launches {launches} ({card})")
    if (st["deposits_dropped"] != 0 or st["dropped"] != 0 or launches["deposit_stream"] == 0
            or not bool(torch.isfinite(img).all())):
        raise SystemExit("phase 12 failed: the stream deposit's pass is wrong")
    return row, launches


def phase_kslot(card: str, device) -> None:
    """A 64 x 64 pass at 2 eye slots a pixel on the card held to the CPU's,
    same draws, as phase 4; the Newton kernel's launches counted."""
    from raytrace3_tpu_torch.core.sampling import (GeneratorDraws, RecordingDraws,
                                                   ReplayDraws)
    from raytrace3_tpu_torch.testing import (MAX_FLIPS, pinned_segments,
                                             recording_segments)

    draws = RecordingDraws(GeneratorDraws(torch.Generator().manual_seed(5)))
    _, _, fn_cpu = make_pass(KSLOT, "cpu")
    with recording_segments() as steps:
        img_c, st_c = fn_cpu(draws)
    _, _, fn_gpu = make_pass(KSLOT, device)
    zero_counters()
    with pinned_segments(steps["eye"], steps["photon"]) as report:
        img_g, st_g = fn_gpu(ReplayDraws(draws.arrays, device=device))
    launches = read_counters()
    lanes = steps["eye"][0][0][4].numel()
    img_g, img_c = img_g.cpu().numpy(), img_c.numpy()
    st_g = {k: float(v) for k, v in st_g.items()}
    st_c = {k: float(v) for k, v in st_c.items()}
    l1 = float(np.abs(img_g - img_c).sum() / np.abs(img_c).sum())
    print(f"[13] K-slot pass card vs cpu, 2 slots ({lanes} eye lanes), held segment by "
          f"segment: {report.segments} segments, lanes per class {report.lanes}; launches "
          f"{launches}")
    print(f"[13] stats card {st_g}\n[13] stats cpu  {st_c}\n[13] image relative L1 {l1:.3g}")
    ok = (report.segments == {"eye": len(steps["eye"]), "photon": len(steps["photon"])}
          and lanes == 2 * KSLOT["width"] * KSLOT["height"]
          and report.lanes["self-hit flip"] <= MAX_FLIPS
          and all(st_g[k] == st_c[k] for k in
                  ("count", "dropped", "deposits_dropped", "photons_emitted"))
          and np.isfinite(img_g).all() and st_c["count"] > 3600 and l1 <= SMALL_L1_RTOL
          and launches["newton"] > 0)
    if not ok:
        raise SystemExit("phase 13 failed: the card's K-slot pass disagrees with the CPU's")


def phase_compaction(card: str, device, deps) -> None:
    """``sppm.compact_round`` on phase 3's bench round through the tile
    deposit: a fraction above the valid share keeps every deposit, one
    below it drops valid - cap exactly."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (make_tile_deposit,
                                                        world_bounds_from_scene)
    from raytrace3_tpu_torch.render.sppm import compact_round

    _, scene, hp, _ = bench_hitpoints(device)
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    dep_fn = make_tile_deposit(tile=TILE, **{k: b[k] for k in BOUNDS})
    D, nv = deps.valid.shape[0], int(deps.valid.sum())
    share = nv / D
    out = lambda d: torch.cat([c[:, None] if c.dim() == 1 else c
                               for c in dep_fn(hp, d)[:2]], 1)
    want = out(deps)
    keep_frac, cut_frac = min(share + 0.05, 0.99), share / 2
    kept, kept_drops = compact_round(deps, keep_frac)
    got = out(kept)
    cnt_mismatch, rel, _ = compare_deposit(got, want)
    cut, cut_drops = compact_round(deps, cut_frac)
    cap = max(int(D * cut_frac), 128)
    out(cut)
    print(f"[14] compaction on the bench round: {nv} valid of {D} deposits (share "
          f"{share:.4f}); at {keep_frac:.4f}: {kept.valid.shape[0]} records, dropped "
          f"{int(kept_drops)}, count mismatches {cnt_mismatch}, max relative flux error "
          f"{rel:.3g}; at {cut_frac:.4f}: cap {cap}, dropped {int(cut_drops)} (valid - cap "
          f"= {nv - cap}), kept valid {int(cut.valid.sum())} ({card})")
    if (int(kept_drops) != 0 or cnt_mismatch or not rel <= DEPOSIT_FLUX_RTOL
            or int(cut_drops) != nv - cap or int(cut.valid.sum()) != cap
            or kept.valid.shape[0] >= D or float(want[:, 0].sum()) == 0):
        raise SystemExit("phase 14 failed: the compacted deposit disagrees or miscounts")


def _epa_case(seed: int = 0, C: int = 60, D: int = 200):
    """tests/test_torch_epa.py's dense case (60 hit points, 200 deposits in
    a 10^3 box), drawn with numpy."""
    from raytrace3_tpu_torch.core.types import Deposits, make_hitpoints

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    hp = make_hitpoints(C, 2.0, "cpu", torch.float32).replace(
        pos=f(rng.uniform(0, 10, (C, 3))), n=f(unit(rng.normal(size=(C, 3)))),
        wgt=f(rng.uniform(0, 1, (C, 3))), valid=torch.as_tensor(rng.uniform(size=C) > 0.1),
        r2=f(rng.uniform(0.5, 2.0, C)))
    dep = Deposits(pos=f(rng.uniform(0, 10, (D, 3))), n=f(unit(rng.normal(size=(D, 3)))),
                   flux=f(rng.uniform(0, 5, (D, 3))),
                   valid=torch.as_tensor(rng.uniform(size=D) > 0.2))
    return hp, dep


def epa_grads(hp, dep, device):
    """(count, d_tao, gradients w.r.t. deposit positions, hit positions, r2)
    of a weighted sum of the Epanechnikov deposit's flux on ``device``."""
    from raytrace3_tpu_torch.render.deposit import deposit_bruteforce_epa

    to = lambda rec: rec.replace(**{f.name: getattr(rec, f.name).to(device)
                                    for f in dataclasses.fields(rec)})
    hp, dep = to(hp), to(dep)
    args = [x.clone().requires_grad_(True) for x in (dep.pos, hp.pos, hp.r2)]
    cnt, tao = deposit_bruteforce_epa(hp.replace(pos=args[1], r2=args[2]),
                                      dep.replace(pos=args[0]), chunk=128)
    w = 0.5 + 0.01 * torch.arange(tao.numel(), dtype=tao.dtype, device=device).reshape(tao.shape)
    grads = torch.autograd.grad((tao * w).sum(), args)
    return [x.detach().cpu() for x in (cnt, tao, *grads)]


def phase_epa(card: str, device) -> None:
    """The Epanechnikov deposit: card against CPU, then one 64^2 train step
    through it with its peak memory."""
    from raytrace3_tpu_torch.diff.train import extract_params, make_train_step
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.deposit import deposit_bruteforce_epa
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    hp, dep = _epa_case()
    got, want = epa_grads(hp, dep, device), epa_grads(hp, dep, "cpu")
    cnt_ok = torch.equal(got[0], want[0])
    flux_rel = float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30))[want[1] > 0].max())
    grad_err = {n: float((g - w).abs().max() / w.abs().max())
                for n, g, w in zip(("dpos", "hpos", "r2"), got[2:], want[2:])}
    print(f"[15] Epanechnikov deposit card vs cpu (60 hit points, 200 deposits): counts equal "
          f"{cnt_ok}, max relative flux error {flux_rel:.3g}, gradients max |d| / max |g| "
          + ", ".join(f"{k} {v:.3g}" for k, v in grad_err.items()))
    if (not cnt_ok or not flux_rel <= EPA_FLUX_RTOL or float(want[1].max()) <= 0
            or not all(v <= EPA_GRAD_ATOL for v in grad_err.values())
            or not all(float(w.abs().max()) > 0 for w in want[2:])):
        raise SystemExit("phase 15 failed: the Epanechnikov deposit on the card disagrees "
                         "with the CPU's")

    cfg = RenderConfig(**EPA_TRAIN)
    scene = build_scene(cfg, device)
    init_fn, step_fn = make_train_step(scene, cfg, newton_fn=make_newton(cfg.newton_iters,
                                                                          RESTARTS),
                                       deposit_fn=deposit_bruteforce_epa)
    params = extract_params(scene)
    params["diff"] = params["diff"] * 0.5
    opt = init_fn(params)
    target = torch.full((cfg.height, cfg.width, 3), 0.5, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, _, loss, st = step_fn(params, opt, torch.Generator(device=device).manual_seed(0), target)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    gmax = {k: float(v.grad.abs().max()) for k, v in params.items()}
    st = {k: int(v) for k, v in st.items()}
    print(f"[15] train step at {cfg.width}x{cfg.height} ({cfg.rounds} x "
          f"{cfg.photons_per_round} photons, C = {cfg.hitpoint_capacity}) through "
          f"deposit_bruteforce_epa: {step_s:.3f} s, peak {peak_gb:.3f} GB above the inputs, "
          f"loss {float(loss):.6g}, stats {st}, max |grad| {gmax} ({card})")
    if (not np.isfinite(float(loss)) or st != {"deposits_dropped": 0, "dropped": 0}
            or not all(np.isfinite(v) for v in gmax.values())
            or not gmax["diff"] > 0 or not gmax["atlas"] > 0):
        raise SystemExit("phase 15 failed: the Epanechnikov train step is wrong")


def built_libraries() -> dict:
    """The kernels' libraries in the build directory, with their times."""
    from raytrace3_tpu_torch.ops import cuda_build

    return {p.name: p.stat().st_mtime_ns for p in cuda_build.BUILD_DIR.glob("*.so")}


#: The deposit wrappers whose inputs ``held_inputs`` can record, by module.
DEPOSIT_WRAPPERS = {"deposit_tile": "raytrace3_tpu_torch.ops.deposit_kernel",
                    "deposit_block": "raytrace3_tpu_torch.ops.deposit_kernel",
                    "deposit_lane": "raytrace3_tpu_torch.ops.lane_kernel",
                    "deposit_lane_bwd": "raytrace3_tpu_torch.ops.lane_kernel"}
#: The Newton call ``held_inputs`` records: this many calls after the run's
#: first deposit, a photon segment of round 1 (phase 2 takes segment 3).
NEWTON_HELD_CALL = 3


@contextlib.contextmanager
def held_inputs(picks: dict, newton_fn=None):
    """Inside, clones of the inputs of chosen kernel calls of the path:
    call number ``picks[name]`` (from 0) of each deposit wrapper named, and
    with ``newton_fn`` the NEWTON_HELD_CALL-th call of the solver yielded
    beside them after the first deposit.  Yields (inputs by kernel name,
    that solver or None).  Recording calls the wrappers unchanged, so each
    still counts its own launches."""
    import importlib

    held, calls = {}, dict.fromkeys([*picks, "newton"], 0)
    clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a

    def tap(name, fn):
        def call(*args):
            if calls[name] == picks[name]:
                held[name] = tuple(clone(a) for a in args)
            calls[name] += 1
            return fn(*args)
        return call

    def solver(org, dir, ctrl):
        if any(calls[k] for k in picks):
            if calls["newton"] == NEWTON_HELD_CALL:
                held["newton"] = (org.clone(), dir.clone(), ctrl.clone())
            calls["newton"] += 1
        return newton_fn(org, dir, ctrl)

    modules = {name: importlib.import_module(DEPOSIT_WRAPPERS[name]) for name in picks}
    originals = {name: getattr(m, name) for name, m in modules.items()}
    for name, m in modules.items():
        setattr(m, name, tap(name, originals[name]))
    try:
        yield held, solver if newton_fn is not None else None
    finally:
        for name, m in modules.items():
            setattr(m, name, originals[name])


def hold_kernels(held: dict, newton_fn=None) -> list[dict]:
    """Each recorded kernel call of ``held_inputs`` against its plain twin
    on the same inputs: the deposits' counts exactly and their flux to
    DEPOSIT_FLUX_RTOL of the twin summed in float64 (the transpose's d_flux
    to DEPOSIT_FLUX_RTOL of the twin's sum of its terms' magnitudes, since
    the cotangent is signed, and to itself bit for bit over two calls);
    Newton's hits, patch ids and t, u, v to NEWTON_ATOL (bit for bit)."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (deposit_block, deposit_block_plain,
                                                        deposit_tile, deposit_tile_plain)
    from raytrace3_tpu_torch.ops.lane_kernel import (deposit_lane, deposit_lane_bwd,
                                                     deposit_lane_bwd_plain, deposit_lane_plain)
    from raytrace3_tpu_torch.ops.newton_kernel import solve_plain

    f64 = dict(sum_dtype=torch.float64)
    twins = {"deposit_tile": (deposit_tile, deposit_tile_plain),
             "deposit_block": (deposit_block, deposit_block_plain),
             "deposit_lane": (deposit_lane, deposit_lane_plain)}
    rows = []
    for name, args in held.items():
        if name == "newton":
            got, want = newton_fn(*args), solve_plain(*args, **newton_fn.keywords)
            both = got[4] & want[4]
            err = max(float((g - w)[both].abs().max()) if bool(both.any()) else 0.0
                      for g, w in zip(got[:3], want[:3]))
            hit_mismatch = int((got[4] != want[4]).sum())
            pid_mismatch = int((both & (got[3] != want[3])).sum())
            rows.append(dict(kernel=name, shape=f"{args[0].shape[0]} rays x "
                             f"{args[2].shape[0]} patches", hits=int(want[4].sum()),
                             hit_mismatch=hit_mismatch, pid_mismatch=pid_mismatch, err=err,
                             ok=not hit_mismatch and not pid_mismatch and err <= NEWTON_ATOL
                             and int(want[4].sum()) > 0))
        elif name == "deposit_lane_bwd":
            *items, packed, u, dep_packed, tile, chunk = args
            got, again = deposit_lane_bwd(*args), deposit_lane_bwd(*args)
            want = deposit_lane_bwd_plain(*items, packed, u, dep_packed, tile, **f64)
            scale = deposit_lane_bwd_plain(*items, packed, u.abs(), dep_packed, tile, **f64)
            rel = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
            bitwise = bool(torch.equal(got, again))
            rows.append(dict(kernel=name, shape=f"{packed.shape[0]} hit slots x "
                             f"{dep_packed.shape[1]} deposit lanes, {items[2].shape[0]} items",
                             rel=rel, bitwise=bitwise, ok=rel <= DEPOSIT_FLUX_RTOL and bitwise
                             and float(scale.max()) > 0))
        else:
            kernel, plain = twins[name]
            # (wt, blk, wcmp, packed, dep_packed, tile, wchunk) for the
            # block deposit; the others end at (packed, dep_packed).
            packed, dep_packed = args[3:5] if name == "deposit_block" else args[-2:]
            want = plain(*args, **f64)
            cnt_mismatch, rel, _ = compare_deposit(kernel(*args), want)
            rows.append(dict(kernel=name, shape=f"{packed.shape[0]} hit slots x "
                             f"{dep_packed.shape[1]} deposit lanes",
                             pairs=int(want[:, 0].sum()), cnt_mismatch=cnt_mismatch, rel=rel,
                             ok=not cnt_mismatch and rel <= DEPOSIT_FLUX_RTOL
                             and int(want[:, 0].sum()) > 0))
    return rows


def check_holds(phase: int, what: str, holds_by_rank, want: set, card: str) -> None:
    """Print every rank's kernel holds; fail the phase on a miss, or when a
    kernel of ``want`` was not held on every rank."""
    for rank, holds in enumerate(holds_by_rank):
        for h in holds:
            facts = ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in h.items() if k not in ("kernel", "shape", "ok"))
            print(f"[{phase}] {what} rank {rank}: {h['kernel']} on the path's own inputs "
                  f"({h['shape']}) vs its plain twin: {facts}; holds {h['ok']} ({card})")
        if {h["kernel"] for h in holds} != want or not all(h["ok"] for h in holds):
            raise SystemExit(f"phase {phase} failed: a kernel of the {what} disagrees with its "
                             "plain twin on the path's inputs, or was not held")


def sharded_rank(passes: int, modes, equal_check: bool) -> dict:
    """One rank of the sharded path: ``cli``'s config and backends of
    SHARDED_FLAGS, then for each ``hp_sharded`` in ``modes`` a
    ``render_sharded`` of ``passes`` passes, the launch counters zeroed just
    before it and read just after.  With ``equal_check`` (a 1 x 1 mesh) it
    first holds one sharded pass to ``make_pass_fn``'s with the same
    generator."""
    from raytrace3_tpu_torch import cli
    from raytrace3_tpu_torch.parallel.mesh import make_mesh
    from raytrace3_tpu_torch.parallel.shard import make_sharded_pass_fn, render_sharded
    from raytrace3_tpu_torch.render.driver import (CAMERA_LOOK, CAMERA_POS, build_scene,
                                                   make_pass_fn)

    torch.set_num_threads(4)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        SHARDED_FLAGS + ["--passes", str(passes)]))
    mesh = make_mesh()
    scene = build_scene(cfg, mesh.device)
    newton_fn, deposit_fn = cli.make_backends(cfg, scene)
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape), "staged": mesh.staged,
           "device": str(mesh.device), "deposit": type(deposit_fn).__name__,
           "tile": getattr(deposit_fn, "tile", None), "capacity": cfg.hitpoint_capacity}
    if equal_check:
        gen = lambda: torch.Generator(device=mesh.device).manual_seed(11)
        fn = make_sharded_pass_fn(scene, cfg, CAMERA_POS, CAMERA_LOOK, mesh, deposit_fn,
                                  newton_fn)
        g = gen()
        img, st = fn(g, g)
        want, st_w = make_pass_fn(scene, cfg, CAMERA_POS, CAMERA_LOOK, deposit_fn,
                                  newton_fn)(gen())
        out["equal"] = bool(torch.equal(img, want))
        out["counters"] = {k: (float(v), float(st_w[k])) for k, v in st.items()}
    for hp_sharded in modes:
        # The tile deposit's first call, or on the ring its second: the
        # neighbour's batch against this rank's shard.
        picks = {"deposit_tile": 1 if hp_sharded else 0}
        with tempfile.TemporaryDirectory() as tmp, held_inputs(picks, newton_fn) as (held, solver):
            jl = os.path.join(tmp, "m.jsonl")
            zero_counters()
            torch.cuda.synchronize()
            img, metrics = render_sharded(cfg, mesh, scene, deposit_fn, solver,
                                          hp_sharded=hp_sharded, metrics_jsonl=jl)
            launches = read_counters()
            per_pass = [json.loads(line)["pass_seconds"] for line in open(jl)]
        out["ring" if hp_sharded else "gather"] = dict(
            metrics=metrics, launches=launches, image=img, per_pass=per_pass,
            finite=bool(np.isfinite(img).all()), mean=float(img.mean()),
            peak_gb=torch.cuda.max_memory_allocated(mesh.device) / 1e9,
            holds=hold_kernels(held, newton_fn))
    return out


def sharded_train_rank(steps: int) -> dict:
    """One rank of a sharded train step at train256's width (phase 9's
    config, its deposit the lane kernel sized by the rank's share): ``steps``
    steps from half the albedos toward a black target, each rank's photons
    from its own generator; the launch counters zeroed just before."""
    from raytrace3_tpu_torch.diff.train import extract_params, make_train_step
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.parallel.mesh import make_mesh
    from raytrace3_tpu_torch.parallel.shard import shard_generators
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    torch.set_num_threads(4)
    cfg = RenderConfig(**TRAIN)
    mesh = make_mesh()
    scene = build_scene(cfg, mesh.device)
    init_fn, step_fn = make_train_step(scene, cfg, newton_fn=make_newton(cfg.newton_iters,
                                                                         RESTARTS), mesh=mesh)
    params = extract_params(scene)
    params["diff"] = params["diff"] * 0.5
    opt = init_fn(params)
    target = torch.zeros((cfg.height, cfg.width, 3), device=mesh.device)
    losses, stats = [], []
    with held_inputs({"deposit_lane": 0, "deposit_lane_bwd": 0}) as (held, _):
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            params, opt, loss, st = step_fn(params, opt, shard_generators(i, 0, mesh)[1],
                                            target)
            losses.append(float(loss))
            stats.append({k: int(v) for k, v in st.items()})
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - t0, read_counters()
    return {"rank": mesh.rank, "staged": mesh.staged, "losses": losses, "stats": stats,
            "s_per_step": seconds / steps, "launches": launches, "holds": hold_kernels(held),
            "grads": {k: v.grad.cpu().numpy() for k, v in params.items()},
            "params": {k: v.detach().cpu().numpy() for k, v in params.items()}}


def dryrun_rank() -> dict:
    """One rank of ``parallel/dryrun.py``, with its launch counts."""
    from raytrace3_tpu_torch.parallel.dryrun import dryrun

    torch.set_num_threads(2)
    zero_counters()
    out = dryrun()
    out["launches"] = read_counters()
    return out


def sum_launches(outs, key=None) -> dict:
    """Each kernel's launches summed over the ranks' results."""
    parts = [o[key]["launches"] if key else o["launches"] for o in outs]
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def check_sharded(phase: int, outs, key: str, card: str) -> dict:
    """Print and check one ``render_sharded`` run of every rank: the same
    image bit for bit, finite and lit, both summed drop counters 0, the
    kernels #1 and #2 launched; returns the launches summed over ranks."""
    runs = [o[key] for o in outs]
    m = runs[0]["metrics"]
    meter = m["meter"]
    launches = sum_launches(outs, key)
    same = all(np.array_equal(r["image"], runs[0]["image"]) for r in runs)
    print(f"[{phase}] {key}: {outs[0]['mesh']} mesh, {meter['passes']} super-passes, "
          f"{meter['total_seconds'] / meter['passes']:.3f} s/pass (rank 0's passes "
          f"{[round(x, 3) for x in runs[0]['per_pass']]} s), "
          f"{meter['photons_per_s']:.0f} photons/s, {meter['mrays_per_s']:.2f} Mrays/s; "
          f"dropped {m['dropped']}, deposits_dropped {m['deposits_dropped']} (summed over "
          f"every pass and rank); newton {launches['newton']}, deposit_tile "
          f"{launches['deposit_tile']} launches; ranks' images bit-equal {same}; peak "
          f"{max(r['peak_gb'] for r in runs):.2f} GB a rank ({card})")
    check_holds(phase, f"{key} run", [r["holds"] for r in runs], {"deposit_tile", "newton"},
                card)
    ok = (same and all(r["finite"] and r["mean"] > 0 for r in runs)
          and all(r["metrics"]["dropped"] == 0 and r["metrics"]["deposits_dropped"] == 0
                  for r in runs)
          and launches["newton"] > 0 and launches["deposit_tile"] > 0)
    if not ok:
        raise SystemExit(f"phase {phase} failed: the sharded render ({key}) is wrong")
    return launches


def phase_sharded(card: str) -> dict:
    """Phase 16: the sharded render at the sharded10m width over NCCL, one
    rank a card; on one card the 1 x 1 pass equals make_pass_fn's."""
    from raytrace3_tpu_torch.parallel.launch import spawn

    world = torch.cuda.device_count()
    before = built_libraries()
    t0 = time.perf_counter()
    outs = spawn(sharded_rank, world, (SHARDED_PASSES, (False,), world == 1),
                 backend="nccl", timeout=SPAWN_TIMEOUT)
    print(f"[16] {world} rank(s) over NCCL in {time.perf_counter() - t0:.1f} s; deposit "
          f"{outs[0]['deposit']} tile {outs[0]['tile']}, capacity {outs[0]['capacity']}; the "
          f"ranks loaded phase 1's kernels: {built_libraries() == before}")
    if built_libraries() != before:
        raise SystemExit("phase 16 failed: a rank rebuilt the kernels")
    if world == 1:
        o = outs[0]
        print(f"[16] 1 x 1 sharded pass vs make_pass_fn with the same generator: image bit "
              f"for bit {o['equal']}; counters (sharded, make_pass_fn) {o['counters']}")
        if not o["equal"] or any(a != b for a, b in o["counters"].values()):
            raise SystemExit("phase 16 failed: the 1 x 1 sharded pass is not make_pass_fn's")
    return check_sharded(16, outs, "gather", card)


def check_train(phase: int, outs, card: str) -> dict:
    launches = sum_launches(outs)
    same = all(np.array_equal(o["grads"][k], outs[0]["grads"][k])
               and np.array_equal(o["params"][k], outs[0]["params"][k])
               for o in outs for k in outs[0]["grads"])
    print(f"[{phase}] sharded train step, {len(outs)} ranks (staged {outs[0]['staged']}): "
          f"losses {outs[0]['losses']}, stats {outs[0]['stats']}, "
          f"{max(o['s_per_step'] for o in outs):.3f} s/step; gradients and params equal "
          f"across ranks {same}; max |grad| "
          f"{ {k: float(np.abs(g).max()) for k, g in outs[0]['grads'].items()} }; launches "
          f"{launches} ({card})")
    check_holds(phase, "train step", [o["holds"] for o in outs],
                {"deposit_lane", "deposit_lane_bwd"}, card)
    ok = (same and all(np.isfinite(o["losses"]).all() for o in outs)
          and all(s == {"deposits_dropped": 0, "dropped": 0} for o in outs for s in o["stats"])
          and all(np.isfinite(g).all() for g in outs[0]["grads"].values())
          and float(np.abs(outs[0]["grads"]["diff"]).max()) > 0
          and all(launches[k] > 0 for k in ("newton", "deposit_lane", "deposit_lane_bwd")))
    if not ok:
        raise SystemExit(f"phase {phase} failed: the sharded train step is wrong")
    return launches


def phase_sharded_gloo(card: str) -> dict:
    """Phase 17: two ranks on the one card over gloo, every collective
    staged through host memory: the 1 x 2 photon-axis pass and the
    --hp-sharded ring at the sharded10m width, then a 2-rank train step at
    train256's; with two cards or more the same over NCCL, one rank a card."""
    from raytrace3_tpu_torch.parallel.launch import spawn

    launches = {}
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    for backend in backends:
        t0 = time.perf_counter()
        outs = spawn(sharded_rank, 2, (GLOO_PASSES, (False, True), False), backend=backend,
                     timeout=SPAWN_TIMEOUT)
        print(f"[17] 2 ranks over {backend} (host-staged collectives: {outs[0]['staged']}) "
              f"on {[o['device'] for o in outs]}, {time.perf_counter() - t0:.1f} s")
        if backend == "gloo" and not outs[0]["staged"]:
            raise SystemExit("phase 17 failed: gloo with CUDA tensors was not host-staged")
        for key in ("gather", "ring"):
            got = check_sharded(17, outs, key, card)
            launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        train = spawn(sharded_train_rank, 2, (GLOO_TRAIN_STEPS,), backend=backend,
                      timeout=SPAWN_TIMEOUT)
        got = check_train(17, train, card)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    return launches


def phase_dryrun(card: str) -> dict:
    """Phase 18: ``parallel/dryrun.py`` on DRYRUN_RANKS ranks (a 2 x 4
    mesh, MULTICHIP_r05.json's), on the card as phase 17 runs its ranks
    (gloo, host-staged; NCCL with a card a rank)."""
    from raytrace3_tpu_torch.parallel.launch import spawn

    backend = "nccl" if torch.cuda.device_count() >= DRYRUN_RANKS else "gloo"
    t0 = time.perf_counter()
    outs = spawn(dryrun_rank, DRYRUN_RANKS, backend=backend, timeout=SPAWN_TIMEOUT)
    launches = sum_launches(outs)
    o = outs[0]
    print(f"[18] dryrun on {DRYRUN_RANKS} ranks over {backend}: mesh {o['mesh']}, forward "
          f"{o['forward']}, train {o['train']}, loss {o['loss']:.6g}, max |grad| "
          f"{o['grad_max']}; launches {launches}; {time.perf_counter() - t0:.1f} s ({card})")
    ok = (o["mesh"] == {"pass": 2, "photon": DRYRUN_RANKS // 2}
          and all(x["loss"] == o["loss"] and x["grad_max"] == o["grad_max"] for x in outs)
          and all(launches[k] > 0 for k in ("newton", "deposit_tile", "deposit_lane",
                                            "deposit_lane_bwd")))
    if not ok:
        raise SystemExit("phase 18 failed: the dry run's ranks disagree or skipped a kernel")
    return launches


def hold_newton(org, dir, ctrl, iters: int, restarts: int) -> dict:
    """Kernel #1 on the rays against its plain twin: hits, patch ids and
    t, u, v to NEWTON_ATOL.  The twin solves the rays that open some patch
    box, STUDY_CHUNK a call; the others must read a miss from the kernel."""
    from raytrace3_tpu_torch.ops.newton_kernel import BIG, open_pairs, solve, solve_plain

    R, device = org.shape[0], org.device
    got = solve(org, dir, ctrl, iters, restarts)
    want = [torch.full((R,), BIG, device=device), torch.zeros(R, device=device),
            torch.zeros(R, device=device), torch.zeros(R, dtype=torch.int32, device=device),
            torch.zeros(R, dtype=torch.bool, device=device)]
    rows_open = torch.nonzero(open_pairs(org, dir, ctrl).any(1)).squeeze(1)
    for i in range(0, len(rows_open), STUDY_CHUNK):
        idx = rows_open[i:i + STUDY_CHUNK]
        for w, x in zip(want, solve_plain(org[idx], dir[idx], ctrl, iters, restarts)):
            w[idx] = x
    both = got[4] & want[4]
    return dict(hits=int(want[4].sum()), hit_mismatch=int((got[4] != want[4]).sum()),
                pid_mismatch=int((both & (got[3] != want[3])).sum()),
                max_abs_err=max(float((g - w)[both].abs().max()) if bool(both.any()) else 0.0
                                for g, w in zip(got[:3], want[:3])))


def phase_restarts(card: str, device) -> tuple[dict, dict]:
    """Phase 19: kernel #1 against its plain twin, bit for bit, at each of
    STUDY_RESTARTS on each of the restart study's three populations cut to
    STUDY_RAYS rays (the very calls the study makes), with its times on the
    three together, bound, open pairs and lane fill per restart count; then
    the study's metrics at that cut, the launch counters zeroed just before
    and read just after."""
    from raytrace3_tpu_torch.ops.newton_kernel import THREADS, drain_schedule, open_pairs, solve
    from raytrace3_tpu_torch.testing import load_script

    study = load_script("torch_newton_restart_study")
    t0 = time.perf_counter()
    ctrl = study.study_ctrl(device)
    pops = {k: (o[::len(o) // STUDY_RAYS], d[::len(d) // STUDY_RAYS])
            for k, (o, d) in study.populations(ctrl).items()}
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    rays = {k: (dev(o), dev(d)) for k, (o, d) in pops.items()}
    org = torch.cat([o for o, _ in rays.values()])
    dir = torch.cat([d for _, d in rays.values()])
    R, B = org.shape[0], ctrl.shape[0]
    gate = open_pairs(org, dir, ctrl)
    by_restarts = {}
    for r in STUDY_RESTARTS:
        holds = {k: hold_newton(o, d, ctrl, study.ITERS, r) for k, (o, d) in rays.items()}
        hits = sum(h["hits"] for h in holds.values())
        hit_mismatch = sum(h["hit_mismatch"] for h in holds.values())
        pid_mismatch = sum(h["pid_mismatch"] for h in holds.values())
        err = max(h["max_abs_err"] for h in holds.values())
        times = kernel_times(lambda: solve(org, dir, ctrl, study.ITERS, r))
        open_lanes = int(gate.sum()) * r
        sched = drain_schedule(gate, r)
        ops = (B * NEWTON_BOX_OPS + R * NEWTON_RAY_OPS + R * B * NEWTON_PAIR_OPS
               + open_lanes * (NEWTON_START_OPS + study.ITERS * NEWTON_ITER_OPS))
        bound_ms, bound_by = bound(ops, R * 24 + B * 48 * 4 + R * 17)
        by_restarts[str(r)] = dict(ms=times[0], call_ms=times[1], bound_ms=bound_ms,
                                   bound_by=bound_by, open_pairs=int(gate.sum()),
                                   lane_fill=sched["lane_fill"], hits=hits,
                                   hit_mismatch=hit_mismatch, pid_mismatch=pid_mismatch,
                                   max_abs_err=err)
        print(f"[19] newton at {r} restarts on each of {', '.join(pops)} ({STUDY_RAYS} rays) "
              f"x {B} patches vs its plain twin: " + "; ".join(
                  f"{k} hits {h['hits']}, hit mismatches {h['hit_mismatch']}, pid mismatches "
                  f"{h['pid_mismatch']}, max |dt, du, dv| {h['max_abs_err']:.3g}"
                  for k, h in holds.items()) +
              f"; on the {R} together: kernel {times[0]:.4f} ms device, {times[1]:.4f} ms a "
              f"call, bound {bound_ms:.5f} ms ({bound_by}), {times[0] / bound_ms:.1f}x; "
              f"{int(gate.sum())} of {R * B} pairs open, {THREADS // r} pairs a Newton step, "
              f"{sched['drains']} drains in {sched['steps']} steps, lane fill "
              f"{sched['lane_fill']:.3f} ({card})")
        if hit_mismatch or pid_mismatch or not err <= NEWTON_ATOL or hits == 0:
            raise SystemExit(f"phase 19 failed: the Newton kernel disagrees with its plain twin "
                             f"at {r} restarts")
    zero_counters()
    torch.cuda.synchronize()
    rows, _ = study.study(pops, ctrl)
    launches = read_counters()
    for name, row in rows.items():
        print(f"[19] study at {STUDY_RAYS} rays, {name}: oracle (64 restarts) hits "
              f"{row['oracle_hits']}; " + "; ".join(
                  f"{r}: miss {row[r]['miss']}, root_diff {row[r]['root_diff']} "
                  f"({row[r]['root_diff_rate']:.4f}), false_hit {row[r]['false_hit']}"
                  for r in map(str, study.CANDIDATES)))
    print(f"[19] {time.perf_counter() - t0:.1f} s; study launches {launches} ({card})")
    if launches["newton"] == 0:
        raise SystemExit("phase 19 failed: the study launched no Newton kernel")
    return by_restarts, launches


def phase_gradcheck(card: str, device) -> dict:
    """Phase 20: the grad check's cuda+lane column, ctrl group only, on
    MIN_CHECKED["ctrl"] coordinates of one realisation; the lane deposit
    and its transpose held to their twins on the first round's inputs, and
    Newton on a photon segment of its first render."""
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.testing import load_script
    from raytrace3_tpu_torch.utils.config import RenderConfig

    gc = load_script("torch_gradcheck")
    t0 = time.perf_counter()
    n = gc.MIN_CHECKED["ctrl"]
    picks = {"ctrl": (n, 0, gc.PICKS["ctrl"][2])}
    newton_fn = make_newton(RenderConfig().newton_iters, 8)
    with held_inputs({"deposit_lane": 0, "deposit_lane_bwd": 0}, newton_fn) as (held, solver):
        zero_counters()
        torch.cuda.synchronize()
        loss, params, drops = gc.make_loss("cuda+lane", device, **{
            k: gc.DEFAULTS[k] for k in ("res", "photons", "rounds")}, newton_fn=solver)
        results = gc.check_at_seed(loss, params, GRADCHECK_SEED, groups=("ctrl",), picks=picks)
        torch.cuda.synchronize()
        launches = read_counters()
    g = gc.summarize("ctrl", results["ctrl"])
    print(f"[20] grad check, ctrl[cuda+lane], {n} candidates of realisation "
          f"{GRADCHECK_SEED}: {g['passed']} of {g['checked']} scored pass (rate "
          f"{g['pass_rate']}, {g['discont_excluded']} excluded); drops {drops}; launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s ({card})")
    check_holds(20, "grad check", [hold_kernels(held, newton_fn)],
                {"deposit_lane", "deposit_lane_bwd", "newton"}, card)
    if drops["deposits_dropped"] or drops["dropped"]:
        raise SystemExit("phase 20 failed: the grad check's renders dropped")
    return launches


def phase_inverse(card: str, device) -> dict:
    """Phase 21: INVERSE_STEPS steps of the albedo recovery at 128^2 (the
    lane deposit's differentiable backward): the loss falls, no deposit or
    eye ray is dropped, and the lane deposit and its transpose hold to
    their twins on their first calls' inputs (the target's first round and
    the first backward)."""
    from raytrace3_tpu_torch.testing import load_script

    inv = load_script("torch_inverse_render")
    args = inv.build_parser().parse_args(["--exp", "albedo", "--steps", str(INVERSE_STEPS)])
    with held_inputs({"deposit_lane": 0, "deposit_lane_bwd": 0}) as (held, _):
        zero_counters()
        torch.cuda.synchronize()
        record, _ = inv.recover(args, device)
        torch.cuda.synchronize()
        launches = read_counters()
    losses = [v for _, v in record["loss_curve"]]
    print(f"[21] albedo recovery at {record['res']}^2, {INVERSE_STEPS} steps: loss "
          f"{record['initial_loss']:.4g} -> {record['final_loss']:.4g}, identifiable parameter "
          f"error {record['initial_param_err_identifiable']} -> "
          f"{record['final_param_err_identifiable']}, {record['step_seconds_mean']} s/step; "
          f"dropped {record['eye_dropped_total']}, deposits_dropped "
          f"{record['deposits_dropped_total']}; launches {launches} ({card})")
    check_holds(21, "albedo recovery", [hold_kernels(held)],
                {"deposit_lane", "deposit_lane_bwd"}, card)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and record["eye_dropped_total"] == 0 and record["deposits_dropped_total"] == 0):
        raise SystemExit("phase 21 failed: the albedo recovery's loss did not fall, or it dropped")
    return launches


def phase_tools(card: str, device) -> dict:
    """Phase 22: the three host-side micro-benchmarks
    (``scripts/torch_perf_{dispatch,compact,depprep}_micro.py``) cut: the
    dispatch tool with its launch and sync counts, the kernels' counters
    read around it; the compaction and prep tools, every candidate's output
    held to the others' and the port's prep to its row-gather twin."""
    from raytrace3_tpu_torch.testing import load_script

    dispatch = load_script("torch_perf_dispatch_micro")
    compact = load_script("torch_perf_compact_micro")
    depprep = load_script("torch_perf_depprep_micro")
    t0 = time.perf_counter()
    zero_counters()
    torch.cuda.synchronize()
    d = dispatch.measure(dict(BENCH, rounds=TOOLS_ROUNDS), device, (TOOLS_ISSUE,), TOOLS_ISSUE)
    torch.cuda.synchronize()
    launches = read_counters()
    issue = sum(d["pass_issue_s"]) / len(d["pass_issue_s"])
    print(f"[22] dispatch ({TOOLS_ROUNDS} rounds): issue {issue:.3f} s a pass, drain "
          f"{d[f'drain_{TOOLS_ISSUE}_passes_s']:.3f} s, wall "
          f"{d[f'wall_per_pass_n{TOOLS_ISSUE}_s']:.3f} s a pass; {d['launches_per_pass']} "
          f"device events a pass, {d['host_us_per_launch']:.2f} host us each; "
          f"{d['syncs_per_pass']} syncs a pass at {len(d['sync_lines'])} lines; .item() "
          f"{d['item_scalar_s']}; launches {launches} ({card})")
    try:
        c = compact.measure(compact.DEFAULTS["n"], compact.DEFAULTS["cap"],
                            compact.DEFAULTS["d"], TOOLS_REPS, device)
        p = depprep.measure(depprep.DEFAULTS["d"], depprep.DEFAULTS["res"],
                            depprep.DEFAULTS["photons"], TOOLS_REPS, device)
    except AssertionError as e:
        raise SystemExit(f"phase 22 failed: {e}") from None
    ms = lambda r: f"{r['device_ms']:.4f}/{r['wall_ms']:.4f}"
    print("[22] compaction (device/wall ms, syncs): " + ", ".join(
        f"{k} {ms(r)} {r['syncs']}" for k, r in {**c["compaction"], **c["key_sort"]}.items())
        + f"; outputs identical ({card})")
    print("[22] deposit prep (device/wall ms): " + ", ".join(
        f"{k} {ms(r)}" for k, r in p["candidates"].items() if r["wall_ms"] is not None)
        + f"; the port's prep equals its twin ({card})")
    print(f"[22] {time.perf_counter() - t0:.1f} s")
    if not (d["launches_per_pass"] and d["syncs_per_pass"] is not None
            and launches["newton"] > 0 and launches["deposit_tile"] > 0
            and not any(d["drops_first_pass"].values())):
        raise SystemExit("phase 22 failed: the dispatch tool's pass missed a count or dropped")
    return launches


def phase_entry(card: str, device) -> None:
    """Phase 23, first part: ``raytrace3_tpu_torch.entry.entry()`` on the
    card, its image finite and positive and equal bit for bit to
    ``entry_pass``'s (``make_pass_fn`` at its config) on the same
    generator, both drop counters 0."""
    from raytrace3_tpu_torch.entry import entry, entry_pass

    t0 = time.perf_counter()
    fn, (gen,) = entry()
    img = fn(gen)
    img2, stats = entry_pass()(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    same = bool(torch.equal(img, img2))
    drops = {k: int(stats[k]) for k in ("dropped", "deposits_dropped")}
    print(f"[23] entry(): image {tuple(img.shape)}, max {float(img.max()):.4g}, finite "
          f"{bool(torch.isfinite(img).all())}, equal to make_pass_fn's bit for bit {same}; "
          f"{drops}; two passes {time.perf_counter() - t0:.1f} s ({card})")
    if not (same and bool(torch.isfinite(img).all()) and float(img.max()) > 0.0
            and tuple(img.shape) == (64, 64, 3) and not any(drops.values())):
        raise SystemExit("phase 23 failed: entry()'s pass is wrong")


def phase_asset_render(card: str, holds: list) -> None:
    """Phase 23: ``scripts/torch_asset_render.py`` cut to FINISH_RES^2 and
    FINISH_PASSES passes on the card, its atlas read from image files the
    phase writes (seeded patterns, PNG by the standard library).  Its tile
    deposit's first call and a Newton call of its photon walk (the script's
    solver, built at its NEWTON, handed in through ``held_inputs``) are
    recorded into ``holds``."""
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.testing import load_script
    from raytrace3_tpu_torch.utils.image import encode_png

    asset = load_script("torch_asset_render")
    newton_fn = make_newton(**asset.NEWTON)
    backends = asset.backends
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    with (tempfile.TemporaryDirectory() as tmp,
          held_inputs({"deposit_tile": 0}, newton_fn) as (held, solver)):
        for stem, side in FINISH_TEXTURES:
            with open(os.path.join(tmp, f"{stem}.png"), "wb") as f:
                f.write(encode_png(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)))
        out = os.path.join(tmp, "asset.json")
        asset.backends = lambda scene, dev: (backends(scene, dev)[0], solver)
        try:
            rc = asset.main(["--res", str(FINISH_RES), "--passes", str(FINISH_PASSES),
                             "--assets", tmp, "--out", out,
                             "--png", os.path.join(tmp, "asset.png")])
        finally:
            asset.backends = backends
        rec = json.load(open(out)) if rc == 0 else {}
        png = os.path.exists(os.path.join(tmp, "asset.png"))
    holds.append(("asset render", held, newton_fn, {"deposit_tile", "newton"}))
    print(f"[23] asset render {FINISH_RES}^2, {FINISH_PASSES} passes: rc {rc}, slots "
          f"{rec.get('asset_slots')}, dropped {rec.get('dropped')}, deposits_dropped "
          f"{rec.get('deposits_dropped')}, {rec.get('meter', {}).get('total_seconds', 0):.2f} s "
          f"of passes; {time.perf_counter() - t0:.1f} s ({card})")
    if not (rc == 0 and png and rec["device"] == "cuda"
            and set(rec["asset_slots"]) == {stem for stem, _ in FINISH_TEXTURES}
            and rec["dropped"] == 0 and rec["deposits_dropped"] == 0):
        raise SystemExit("phase 23 failed: the asset render is wrong")


def phase_finish_tools(card: str, device, holds: list) -> None:
    """Phase 23: the bisect, the deposit micro and the sweep cut
    (``scripts/torch_perf_{bisect,deposit_micro,deposit_sweep}.py``).  The
    bisect's first block deposit and a Newton call of its full pass (kernel
    #1 at its restarts), and the micro's block deposit, are recorded into
    ``holds``; each sweep row holds itself to its plain twin."""
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.testing import load_script

    bisect = load_script("torch_perf_bisect")
    micro = load_script("torch_perf_deposit_micro")
    sweep = load_script("torch_perf_deposit_sweep")
    t0 = time.perf_counter()
    restarts, photons = bisect.JAX_DEFAULTS["restarts"], bisect.JAX_DEFAULTS["photons"]
    newton_fn = make_newton(bisect.config(FINISH_RES, TOOLS_ROUNDS, photons).newton_iters,
                            restarts)
    with held_inputs({"deposit_block": 0}, newton_fn) as (held, solver):
        b = bisect.measure(list(FINISH_VARIANTS), FINISH_RES, TOOLS_ROUNDS, photons, restarts,
                           1, device, newton_fn=solver)
    holds.append((f"bisect's full pass ({restarts} restarts)", held, newton_fn,
                  {"deposit_block", "newton"}))
    for v, r in b.items():
        print(f"[23] bisect {v} at {FINISH_RES}^2, {TOOLS_ROUNDS} rounds: first "
              f"{r['first_pass_seconds']:.3f} s, {r['pass_seconds']:.3f} s a pass, dropped "
              f"{r['dropped']}, deposits_dropped {r['deposits_dropped']}, launches "
              f"{r['launches']} ({card})")
    with held_inputs({"deposit_block": 0}) as (held, _):
        m = micro.measure(micro.DEFAULTS["d"], micro.DEFAULTS["c"], TOOLS_REPS, 0, device)
    holds.append(("deposit micro", held, None, {"deposit_block"}))
    block = m["stages"]["block_deposit_full"]
    print("[23] deposit micro (device/wall ms): " + ", ".join(
        f"{k} {r['device_ms']:.3f}/{r['wall_ms']:.3f}" for k, r in m["stages"].items())
        + f"; block overflow {block['overflow']}, pairs taken {block['pairs_taken']} ({card})")
    rows = [r for r in sweep.configs() if r[0] in FINISH_SWEEP]
    s = sweep.sweep(rows, sweep.DEFAULTS["d"], sweep.DEFAULTS["c"], TOOLS_REPS, device)
    ref = s["counts_reference"]
    for r in s["rows"]:
        facts = r["error"] if "error" in r else (
            f"device {r['device_ms']:.3f} ms, wall {r['wall_ms']:.3f} ms, overflow "
            f"{r['overflow']}, items {r.get('items')}; against its plain twin on the same "
            f"inputs {r['twin_count_mismatch']} count mismatches of {r['twin_pairs']} pairs, "
            f"flux {r['twin_flux_rel']:.3g}, holds {r['holds_twin']}; counts equal to "
            f"{ref}'s {r.get('counts_equal_reference')}")
        print(f"[23] sweep {r['cfg']}: {facts} ({card})")
    print(f"[23] tools {time.perf_counter() - t0:.1f} s")
    full, nonewton = b["full"], b["nonewton"]
    if not (full["launches"]["newton"] > 0 and full["launches"]["deposit_block"] > 0
            and nonewton["launches"]["newton"] == 0 and full["image_finite"]
            and all(r["device_ms"] is not None for r in m["stages"].values())
            and block["pairs_taken"] > 0
            and s["all_rows_ok"] and len(s["rows"]) == len(FINISH_SWEEP)):
        raise SystemExit("phase 23 failed: the bisect, the deposit micro or the sweep is wrong")


def phase_finish(card: str, device) -> dict:
    """Phase 23: ``entry()``, the asset render and the three deposit and
    pass tools, each cut; the kernels' launches counted over all of it as a
    path of its own, then each recorded kernel call held to its plain twin
    on its own inputs (those launches uncounted)."""
    t0 = time.perf_counter()
    holds = []
    zero_counters()
    torch.cuda.synchronize()
    phase_entry(card, device)
    phase_asset_render(card, holds)
    phase_finish_tools(card, device, holds)
    torch.cuda.synchronize()
    launches = read_counters()
    for what, held, newton_fn, want in holds:
        check_holds(23, what, [hold_kernels(held, newton_fn)], want, card)
    print(f"[23] launches {launches}; {time.perf_counter() - t0:.1f} s ({card})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off before any work)
    from raytrace3_tpu_torch.core.device import card_line

    device = torch.device("cuda", 0)
    torch.set_num_threads(8)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    phase_build(card)
    newton = phase_newton(card, device)
    deps = newton.pop("_round")
    walk = phase_walk(card, device)
    eye_rows = phase_eye(card, device)
    deposit = phase_deposit(card, device, deps)
    phase_small(device)
    render = phase_main(card, device)
    r = train_round(device)
    lane = phase_lane(card, r)
    lane_bwd = phase_lane_bwd(card, r, lane.pop("_taken"))
    del r
    phase_small_train(device)
    train = phase_train(card, device)
    block = phase_block(card, device)
    cli_launches = phase_cli(card)
    stream, stream_launches = phase_stream(card, device, deps)
    phase_kslot(card, device)
    phase_compaction(card, device, deps)
    phase_epa(card, device)
    sharded = phase_sharded(card)
    sharded_gloo = phase_sharded_gloo(card)
    dryrun = phase_dryrun(card)
    t0 = time.perf_counter()
    newton["by_restarts"], restarts = phase_restarts(card, device)
    gradcheck = phase_gradcheck(card, device)
    inverse = phase_inverse(card, device)
    print(f"[19-21] {time.perf_counter() - t0:.1f} s ({card})")
    tools = phase_tools(card, device)
    finish = phase_finish(card, device)
    # Each kernel's launches on each path, each path counted from 0: the
    # render pass (phase 5), the train step (phase 9), the CLI at
    # reference1024 (phase 11), the stream deposit's pass (phase 12), the
    # sharded render (phase 16), the two-rank runs on one card (phase 17),
    # the dry run (phase 18), summed over their ranks, the restart study
    # (phase 19), the grad check (phase 20), the albedo recovery (phase 21),
    # the dispatch tool's passes (phase 22) and entry(), the asset render,
    # the bisect, the deposit micro and the sweep (phase 23).
    paths = {"render": render, "train": train, "cli": cli_launches, "stream": stream_launches,
             "sharded": sharded, "sharded_gloo": sharded_gloo, "dryrun": dryrun,
             "restarts": restarts, "gradcheck": gradcheck, "inverse": inverse,
             "tools": tools, "finish": finish}
    rows = (newton, deposit, lane, lane_bwd, block, stream) + walk + eye_rows
    for row in rows:
        name = row["name"]
        row["launches_by_path"] = {p: n[name] for p, n in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] == 0:
            raise SystemExit(f"kernel {name} was launched on no path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: d[k] for k in keys + ("by_restarts",) if k in d}
                                  for d in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
