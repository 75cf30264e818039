#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``raytrace3_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's six CUDA kernels from ``raytrace3_tpu_torch/csrc/``
and drives the port's four paths: the render pass, the train step, the CLI
and the stream deposit's pass.  The render path is the bench
configuration of ``bench.py`` (scene ``full``, 512 x 512, 16 rounds x
131072 photons, depth 13, regen walk, Bezier compaction 0.09 / 0.05, the
staged eye schedule, the tile deposit at tile 256 with 1-D banding, Newton
at 8 restarts x 10 iterations).  The train path is
``scripts/perf_trainstep.py``'s (scene ``full``, 256 x 256, 4 rounds x 32768
photons, depth 13, atlas 64, Bezier compaction 0.12, hit-point factor 1.5,
the slot eye wavefront and the static photon walk, the differentiable lane
deposit at tile 256 / chunk 512 / work cap 16384 with 2-D banding and
merged z windows, Adam on an MSE loss).  Phases, each of which ends the run
with a non-zero exit when it fails:

  1. the card's name and power limit; build the six kernels, in parallel;
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
  5. the render path: ``build_scene`` + ``make_pass_fn``, one warm pass and
     timed passes, with the kernels' launch counters read around them;
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
     around them;
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
     ``DepositStream``.

A kernel's ``ms`` is its device time (``device_ms``: a CUDA graph of 10
launches, replayed); ``call_ms`` is one wrapper call between CUDA events,
which adds the host's share the device waits for.  The second-to-last
line is a JSON object with one entry per kernel; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing either.  It imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: The bench's main-path settings (bench.py:109-119).
BENCH = dict(scene="full", width=512, height=512, passes=1, rounds=16,
             photons_per_round=131072, max_depth=13, atlas_res=128,
             bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
             newton_iters=10, hitpoint_factor=1.3, photon_regen=True,
             eye_compact_schedule=((1, 0.25), (4, 0.04), (6, 0.02)))
RESTARTS = 8
TILE = 256
BASE = np.array([50.0, 35.0, 230.0])                 # main.cpp:24
LOOK = BASE + np.array([0.0, 0.042612, -1.0])        # main.cpp:27
BOUNDS = ("x_lo", "x_hi", "y_lo", "y_hi")
TIMED_PASSES = 2
#: Newton: the kernel evaluates in the plain twin's operation order with
#: -fmad=false, so hits, patch ids and t, u, v must agree bit for bit.
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
#: Phase 11: the CLI's passes at the reference1024 preset, and the card's
#: resume check: a 64^2 render resumed from a one-pass checkpoint against
#: the same render run straight.  The walks are deterministic on the card;
#: only the pixel estimate's index_add_ sums with atomics, in another order
#: each run, so the images agree to RESUME_L1_RTOL relative L1.
CLI_PASSES = 3
RESUME_ARGS = ["--scene", "full", "--res", "64", "--deposit", "pallas", "--pallas",
               "--preview-every", "0"]
RESUME_L1_RTOL = 1e-6
#: Phase 12: the round-3 deposit sweep's stream configuration
#: (scripts/perf_deposit_sweep.py:110-122, ``str1d_t128_ch1024``).
STREAM = dict(tile=128, chunk=1024, work_cap=65536, bucket2d=False)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
           "deposit_block.cu", "deposit_stream.cu")


def all_counters() -> dict:
    """Every kernel's launch counter, by the name of its row."""
    from raytrace3_tpu_torch.ops import deposit_kernel, lane_kernel, newton_kernel

    return {"newton": newton_kernel.KERNEL, "deposit_tile": deposit_kernel.KERNEL,
            "deposit_lane": lane_kernel.FORWARD, "deposit_lane_bwd": lane_kernel.BACKWARD,
            "deposit_block": deposit_kernel.BLOCK_KERNEL,
            "deposit_stream": lane_kernel.STREAM}


def zero_counters() -> None:
    for k in all_counters().values():
        k.launches = 0


def read_counters() -> dict:
    return {name: k.launches for name, k in all_counters().items()}


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
    print(f"[1] all {len(SOURCES)} kernels built in {time.perf_counter() - t0:.1f} s; card: {card}")


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


def bench_hitpoints(device):
    """(cfg, scene, hit points, eye stats) of the bench's 512^2 eye pass."""
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.eye import eye_pass
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**BENCH)
    scene = build_scene(cfg, device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    org, dir = emit_rays(look_at(f32(BASE), f32(LOOK), cfg.width, cfg.height))
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
    """The main path at the bench configuration; returns launch counts."""
    from raytrace3_tpu_torch.render.eye import eye_stage_widths

    cfg, scene, fn = make_pass(BENCH, device)
    gen = torch.Generator(device=device).manual_seed(0)
    zero_counters()
    t0 = time.perf_counter()
    img, stats = fn(gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emitted = []
    for _ in range(TIMED_PASSES):
        img, stats = fn(gen)
        emitted.append(stats["photons_emitted"])
    torch.cuda.synchronize()
    pass_s = (time.perf_counter() - t0) / TIMED_PASSES
    launches = read_counters()

    photons = float(torch.stack(emitted).mean())
    eye_rays = sum(s * w for s, w in eye_stage_widths(
        cfg.n_pixels, cfg.eye_compact_schedule, cfg.max_depth))
    photon_rays = cfg.rounds * (cfg.max_depth + 1) * cfg.photons_per_round
    st = {k: float(v) for k, v in stats.items()}
    print(f"[5] main path {cfg.width}x{cfg.height}, {cfg.rounds} x "
          f"{cfg.photons_per_round} photons: first pass {warm_s:.2f} s, "
          f"{pass_s:.3f} s/pass, {photons / pass_s:.0f} photons/s, "
          f"{(eye_rays + photon_rays) / pass_s / 1e6:.2f} Mrays/s ({card})")
    print(f"[5] stats {st}; launches {launches}")
    ok = (st["deposits_dropped"] == 0 and st["dropped"] == 0 and st["count"] > 0
          and tuple(img.shape) == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(img).all()) and float(img.mean()) > 0
          and launches["newton"] > 0 and launches["deposit_tile"] > 0)
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off before any work)

    device = torch.device("cuda", 0)
    torch.set_num_threads(8)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    phase_build(card)
    newton = phase_newton(card, device)
    deps = newton.pop("_round")
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
    # Each kernel's launches on each path, each path counted from 0: the
    # render pass (phase 5), the train step (phase 9), the CLI at
    # reference1024 (phase 11) and the stream deposit's pass (phase 12).
    paths = {"render": render, "train": train, "cli": cli_launches, "stream": stream_launches}
    rows = (newton, deposit, lane, lane_bwd, block, stream)
    for row in rows:
        name = row["name"]
        row["launches_by_path"] = {p: n[name] for p, n in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] == 0:
            raise SystemExit(f"kernel {name} was launched on no path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
