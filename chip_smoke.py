#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``raytrace3_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's two CUDA kernels from ``raytrace3_tpu_torch/csrc/``
and drives the port's main path, the bench configuration of ``bench.py``
(scene ``full``, 512 x 512, 16 rounds x 131072 photons, depth 13, regen
walk, Bezier compaction 0.09 / 0.05, the staged eye schedule, the tile
deposit at tile 256 with 1-D banding, Newton at 8 restarts x 10
iterations).  Phases, each of which ends the run with a non-zero exit when
it fails:

  1. the card's name and power limit; build both kernels, timed;
  2. the Newton kernel against its plain PyTorch twin on the teapot-bound
     rays of one photon segment at bench shapes;
  3. the tile deposit kernel against its plain twin on one bench round
     (14 x 131072 deposits against the 512^2 hit-point layout);
  4. a small pass (32 x 32, 2 x 1024 photons) on the card against the same
     pass on the CPU (the plain twins) with the same draws, held to it one
     walk segment at a time (``raytrace3_tpu_torch.testing``);
  5. the main path: ``build_scene`` + ``make_pass_fn``, one warm pass and
     timed passes, with both kernels' launch counters read around them.

The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing either.  It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
DEPOSIT_FLUX_RTOL = 1e-5
#: Card vs CPU pass, the walks held segment by segment: every counter equal;
#: the image within SMALL_L1_RTOL relative L1, since the deposit stage then
#: sees identical hit points and deposits and its flux sums differ in order
#: only (DEPOSIT_FLUX_RTOL).
SMALL_L1_RTOL = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events."""
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


def make_pass(settings: dict, device):
    from raytrace3_tpu_torch.ops.deposit_kernel import (make_tile_deposit,
                                                        world_bounds_from_scene)
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene, make_pass_fn
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**settings)
    scene = build_scene(cfg, device)
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    fn = make_pass_fn(scene, cfg, BASE, LOOK,
                      deposit_fn=make_tile_deposit(tile=TILE, **{k: b[k] for k in BOUNDS}),
                      newton_fn=make_newton(cfg.newton_iters, RESTARTS))
    return cfg, scene, fn


def phase_build(card: str) -> None:
    from raytrace3_tpu_torch.ops import cuda_build

    for source in ("newton.cu", "deposit_tile.cu"):
        t0 = time.perf_counter()
        lib = cuda_build.build(source)
        print(f"[1] built {source} in {time.perf_counter() - t0:.1f} s -> {lib.name}")
        for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    print(f"[1] card: {card}")


def phase_newton(card: str, device) -> dict:
    """Kernel vs plain on the Newton inputs of one photon segment."""
    from raytrace3_tpu_torch.ops.newton_kernel import solve, solve_plain
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
    ms = cuda_ms(lambda: solve(org, dir, ctrl, cfg.newton_iters, RESTARTS))
    plain_ms = cuda_ms(lambda: solve_plain(org, dir, ctrl, cfg.newton_iters, RESTARTS), 3)
    print(f"[2] newton: {org.shape[0]} rays x {ctrl.shape[0]} patches x {RESTARTS} restarts; "
          f"hits {int(hit_w.sum())}, hit mismatches {mismatch}, pid mismatches "
          f"{pid_mismatch}, max |dt, du, dv| on common hits {err:.3g}")
    print(f"[2] newton: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})")
    if mismatch or pid_mismatch or not err <= NEWTON_ATOL or int(hit_w.sum()) == 0:
        raise SystemExit("phase 2 failed: the Newton kernel disagrees with its plain twin")
    return dict(name="newton", route="cuda",
                source="raytrace3_tpu_torch/csrc/newton.cu",
                replaces="raytrace3_tpu/ops/newton_pallas.py:122",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, _round=deps)


def phase_deposit(card: str, device, deps) -> dict:
    """Kernel vs plain on one bench round against the 512^2 layout."""
    from raytrace3_tpu_torch.ops.deposit_kernel import (deposit_tile,
                                                        deposit_tile_plain,
                                                        make_tile_deposit,
                                                        world_bounds_from_scene)
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
    cnt_mismatch = int((got[:, 0] != want[:, 0]).sum())
    dflux = (got[:, 1:4] - want[:, 1:4]).abs()
    rel = float((dflux / want[:, 1:4].abs().clamp_min(1e-6)).max())
    err = float((got - want).abs().max())
    pairs = int((ek - sk).sum()) * TILE
    ms = cuda_ms(lambda: deposit_tile(sk, ek, packed, dep_packed))
    plain_ms = cuda_ms(lambda: deposit_tile_plain(sk, ek, packed, dep_packed), 3)
    print(f"[3] deposit: {int(deps.valid.sum())} valid of {deps.pos.shape[0]} deposits, "
          f"{int(st['count'])} hit points in {n_tiles} tiles of {TILE}, "
          f"{pairs / 1e9:.3f} G pair tests; pairs found {int(want[:, 0].sum())}")
    print(f"[3] deposit: count mismatches {cnt_mismatch}, max relative flux error "
          f"{rel:.3g}, max |d out| {err:.3g}")
    print(f"[3] deposit: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})")
    if cnt_mismatch or not rel <= DEPOSIT_FLUX_RTOL or int(want[:, 0].sum()) == 0:
        raise SystemExit("phase 3 failed: the deposit kernel disagrees with its plain twin")
    return dict(name="deposit_tile", route="cuda",
                source="raytrace3_tpu_torch/csrc/deposit_tile.cu",
                replaces="raytrace3_tpu/ops/deposit_pallas.py:862",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


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
    from raytrace3_tpu_torch.ops import deposit_kernel, newton_kernel
    from raytrace3_tpu_torch.render.eye import eye_stage_widths

    cfg, scene, fn = make_pass(BENCH, device)
    gen = torch.Generator(device=device).manual_seed(0)
    newton_kernel.KERNEL.launches = 0
    deposit_kernel.KERNEL.launches = 0
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
    launches = {"newton": newton_kernel.KERNEL.launches,
                "deposit_tile": deposit_kernel.KERNEL.launches}

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
          and all(n > 0 for n in launches.values()))
    if not ok:
        raise SystemExit("phase 5 failed: the main path's result or launches are wrong")
    return launches


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
    del deps
    phase_small(device)
    launches = phase_main(card, device)
    newton["launches"] = launches["newton"]
    deposit["launches"] = launches["deposit_tile"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(card)
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (newton, deposit)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
