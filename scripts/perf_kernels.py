#!/usr/bin/env python3
"""Time the port's redesigned CUDA kernels against an earlier version of the
same kernels, in turns, on the inputs of the port's paths.  Needs one
NVIDIA GPU and nvcc.

    python3 scripts/perf_kernels.py --parent DIR --out FILE [--reps 5] [--sass]

``DIR`` holds the earlier ``csrc`` (``git archive`` of the parent commit's
``raytrace3_tpu_torch/csrc`` unpacked there).  Its tile and block deposits
take the launch geometry as the current ones do when ``DIR`` has
``deposit_stage.cuh`` and end at ``out`` otherwise (the first versions, one
block a tile); likewise its stream and lane deposits when their sources
include that header, and its lane transpose when its source has
``bwd_geometry_fits``.  The Newton entry point is the same in every version.

Kernels and inputs (those chip_smoke.py builds):
  * Newton (#1): the rays of phase 2's photon segment, and the largest
    call a 512^2 bench pass makes (found by recording every call of one
    pass), both versions held to the plain twin bit for bit; and all the
    pass's calls in order as one unit, the versions held to each other;
  * the tile deposit (#2) on the bench round (512^2 hit points, the first
    of 16 x 131072 photons' rounds, tile 256: phase 3) and, at tile 512, on
    a reference1024 round (the CLI's ``--deposit tile`` at 1024^2);
  * the block deposit (#5) on the reference1024 round through
    ``DepositBlock`` as the CLI builds it (tile 1024, wchunk 1024, work cap
    65536: phase 10);
  * the stream deposit (#6) on the bench round through ``DepositStream``
    at tile 128, chunk 1024 (phase 12);
  * the lane deposit (#3) and its transpose (#4) on the train round (256^2
    hit points, 14 x 32768 deposits, ``DepositLane`` at tile 256, chunk
    512, as the train step builds it: phases 6 and 7), #4 with a seeded
    cotangent and checked bit for bit over two calls.
For the deposits: the lanes per tile (and for #3 and #4 the lanes per item
and the items per tile or chunk), and the new and old kernels and the
float32 plain twin against the plain twin with its sums taken in float64
(counts exact, flux rtol 1e-5 for the kernels).  Times: device times
(chip_smoke.device_ms: a CUDA graph of 10 launches, median of ``--reps``
replays) in the order old, new, new, old, and beside them each version's
one-call time (chip_smoke.cuda_ms), all written to ``FILE`` as JSON.
``--sass`` writes ``cuobjdump -sass`` of every library beside it and counts
the instructions of each loop.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from raytrace3_tpu_torch.ops import cuda_build  # noqa: E402
from raytrace3_tpu_torch.ops import deposit_kernel as dk  # noqa: E402
from raytrace3_tpu_torch.ops import lane_kernel as lk  # noqa: E402
from raytrace3_tpu_torch.ops import newton_kernel as nk  # noqa: E402

#: The first versions' deposit entry points end at ``out``.
LEGACY_ARGS = {"tile": dk.KERNEL.argtypes[:9], "block": dk.BLOCK_KERNEL.argtypes[:11],
               "stream": lk.STREAM.argtypes[:10], "lane": lk.FORWARD.argtypes[:10],
               "lane_bwd": lk.BACKWARD.argtypes[:13]}


class ClockSampler:
    """SM clock and power while a block of work runs: ``nvidia-smi -lms``
    sampled in the background, medians on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "20"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines()
                if ln.strip() and "," in ln]
        self.result = (dict(sm_mhz=float(np.median([r[0] for r in rows])),
                            power_w=float(np.median([r[1] for r in rows])), samples=len(rows))
                       if rows else {})
        return False


class Parent:
    """The earlier kernels of ``csrc_dir``: ``kernels[name]`` and whether its
    deposit entry points end at ``out`` (``legacy[name]``)."""

    def __init__(self, csrc_dir: Path):
        staged = (csrc_dir / "deposit_stage.cuh").exists()
        src = lambda name: (csrc_dir / name).read_text()
        self.legacy = {"tile": not staged, "block": not staged,
                       "stream": "deposit_stage.cuh" not in src("deposit_stream.cu"),
                       "lane": "deposit_stage.cuh" not in src("deposit_lane.cu"),
                       "lane_bwd": "bwd_geometry_fits" not in src("deposit_lane_bwd.cu")}
        current = {"tile": dk.KERNEL, "block": dk.BLOCK_KERNEL, "stream": lk.STREAM,
                   "lane": lk.FORWARD, "lane_bwd": lk.BACKWARD}
        self.kernels = {name: cuda_build.CudaKernel(
            k.source, k.symbol, LEGACY_ARGS[name] if self.legacy[name] else k.argtypes, csrc_dir)
            for name, k in current.items()}
        self.kernels["newton"] = cuda_build.CudaKernel(nk.KERNEL.source, nk.KERNEL.symbol,
                                                       nk.KERNEL.argtypes, csrc_dir)

    def deposit(self, name, dev, c_pad, tile, *args):
        """``out`` of deposit kernel ``name`` on ``args`` (those before ``out``)."""
        out = torch.empty((c_pad, 8), dtype=torch.float32, device=dev)
        if self.legacy[name]:
            self.kernels[name].launch(dev, *args, cuda_build.ptr(out))
        else:
            gargs, scratch = dk._geometry_args(tile, c_pad, dev)
            self.kernels[name].launch(dev, *args, cuda_build.ptr(out), *gargs)
            del scratch     # the stream orders its reuse after the kernel
        return out

    def lane(self, item_lo, item_hi, wa, wb, packed, dep_packed):
        """``out`` of the earlier lane deposit."""
        out = torch.empty((packed.shape[0], 8), dtype=torch.float32, device=packed.device)
        if self.legacy["lane"]:
            p = cuda_build.ptr
            self.kernels["lane"].launch(
                packed.device, p(item_lo), p(item_hi), item_lo.shape[0],
                packed.shape[0] // item_lo.shape[0], p(wa), p(wb), p(packed), p(dep_packed),
                dep_packed.shape[1], p(out))
        else:
            lk.launch_lane(self.kernels["lane"], out, item_lo, item_hi, wa, wb, packed,
                           dep_packed)
        return out

    def lane_bwd(self, run_lo, run_hi, wt, wa, wb, packed, u, dep_packed, tile, chunk):
        """The (3, Dp) ``out`` of the earlier lane transpose."""
        Dp = dep_packed.shape[1]
        out = torch.empty((3, Dp), dtype=torch.float32, device=packed.device)
        if self.legacy["lane_bwd"]:
            p = cuda_build.ptr
            self.kernels["lane_bwd"].launch(
                packed.device, p(run_lo), p(run_hi), run_lo.shape[0], chunk, p(wt), p(wa),
                p(wb), tile, p(packed), p(u), p(dep_packed), Dp, p(out))
        else:
            lk.launch_lane_bwd(self.kernels["lane_bwd"], out, run_lo, run_hi, wt, wa, wb,
                               packed, u, dep_packed, tile, chunk)
        return out

    def newton(self, org, dir, ctrl, iters, restarts):
        """The earlier Newton kernel's (t, u, v, pid, hit)."""
        return launch_newton(self.kernels["newton"], org, dir, ctrl, iters, restarts)


def launch_newton(kernel, org, dir, ctrl, iters, restarts):
    """(t, u, v, pid, hit) of a Newton kernel with newton.cu's entry point."""
    dev = org.device
    R = org.shape[0]
    gu, gv = nk.restart_grid_shape(restarts)
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=dev) for _ in range(3))
    pid = torch.empty((R,), dtype=torch.int32, device=dev)
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    p = cuda_build.ptr
    kernel.launch(dev, p(org), p(dir), p(ctrl), R, ctrl.shape[0], restarts, gu, gv, iters,
                  nk.M_EPS, p(t), p(u), p(v), p(pid), p(hit))
    return t, u, v, pid, hit


def bench_round(device):
    """(hit points, deposits, xy bounds, Newton calls of the round's photon
    walk) of chip_smoke.py phases 2 and 3."""
    from raytrace3_tpu_torch.render.photon import photon_trace_regen

    cfg, scene, hp, _ = cs.bench_hitpoints(device)
    photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
    gen = torch.Generator(device=device).manual_seed(1)
    calls = []
    deps, _, _ = photon_trace_regen(photon_scene, gen, scene.light_pos, scene.light_color,
                                    cfg.photons_per_round, None, cfg.max_depth,
                                    newton_fn=recording(calls, cfg.newton_iters))
    b = dk.world_bounds_from_scene(scene, extra_points=[cs.BASE])
    return hp, deps, {k: b[k] for k in cs.BOUNDS}, calls


def recording(calls: list, iters: int):
    """A Newton solver that keeps a copy of every call's inputs."""

    def solve(org, dir, ctrl):
        calls.append((org.clone(), dir.clone(), ctrl))
        return nk.solve(org, dir, ctrl, iters, cs.RESTARTS)

    return solve


def render_pass_calls(device) -> list:
    """The Newton calls of one 512^2 bench pass (chip_smoke.py phase 5's)."""
    calls = []
    cfg = cs.BENCH
    _, _, fn = cs.make_pass(cfg, device, newton_fn=recording(calls, cfg["newton_iters"]))
    fn(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    return calls


def preset_bounds(cfg, device) -> dict:
    from raytrace3_tpu_torch.render.driver import build_scene

    b = dk.world_bounds_from_scene(build_scene(cfg, device), extra_points=[cs.BASE])
    return {k: b[k] for k in cs.BOUNDS}


def layout(depo, hp, deps, granularity):
    """(packed, dep_packed, prep, dkeys, n_tiles, Dp) of a deposit's round."""
    prep = depo.prepare(hp)
    r2_pad, _ = depo.pack_state(hp, prep)
    packed = prep.packed.clone()
    packed[:, 6] = r2_pad
    dkeys, dep_packed, Dp = depo._dep_sorted(deps, granularity)
    return packed, dep_packed, prep, dkeys, packed.shape[0] // depo.tile, Dp


def lane_stats(lanes):
    """Count, max, mean, 99th percentile and the largest's share of a
    per-tile (or per-item, per-chunk) count."""
    x = lanes.double()
    return dict(n=int(x.numel()), max=int(x.max()), mean=float(x.mean()),
                p99=float(torch.quantile(x, 0.99)), heaviest_share=float(x.max() / x.sum()))


def per_run(lo, hi, per_item):
    """Sums of ``per_item`` over each run of items [lo_k, hi_k)."""
    owner, item = lk._runs_items(lo, hi)
    out = torch.zeros(lo.shape[0], dtype=torch.int64, device=lo.device)
    out.index_add_(0, owner, per_item.long()[item])
    return out


def compare(got, want):
    cnt, rel, err = cs.compare_deposit(got, want)
    return dict(count_mismatches=cnt, max_rel_flux=rel, max_abs=err,
                ok=cnt == 0 and rel <= cs.DEPOSIT_FLUX_RTOL)


def against_witness(new, old, plain, witness):
    """The kernels' and the float32 twin's distances from the float64-summed
    twin, and the kernels' from the float32 twin."""
    return dict(new_vs_f64=compare(new, witness), old_vs_f64=compare(old, witness),
                plain_vs_f64=compare(plain, witness), new_vs_plain=compare(new, plain),
                old_vs_plain=compare(old, plain))


def timed(rec, run_old, run_new, reps):
    """Device times in the order old, new, new, old (medians of ``reps``
    graph replays each), then each version's one-call time."""
    with ClockSampler() as clk:
        o1, n1, n2, o2 = (cs.device_ms(f, reps=reps) for f in (run_old, run_new, run_new,
                                                                 run_old))
        old_call, new_call = cs.cuda_ms(run_old, reps), cs.cuda_ms(run_new, reps)
    rec["times"] = dict(old=[o1, o2], new=[n1, n2], old_ms=float(np.median([o1, o2])),
                        new_ms=float(np.median([n1, n2])), old_call_ms=old_call,
                        new_call_ms=new_call)
    rec["clock"] = clk.result
    return rec


def tile_case(name, depo, hp, deps, parent, reps):
    packed, dep_packed, prep, dkeys, n_tiles, Dp = layout(depo, hp, deps, depo.chunk)
    sk, ek = depo._window_lanes(prep, dkeys, n_tiles)
    sk, ek = sk.to(torch.int32).contiguous(), ek.to(torch.int32).contiguous()
    lanes = (torch.clamp(ek.long(), max=Dp) - torch.clamp(sk.long(), min=0)).clamp_min(0).sum(1)
    dev, c_pad, tile, p = packed.device, packed.shape[0], depo.tile, cuda_build.ptr

    def run_old():
        return parent.deposit("tile", dev, c_pad, tile, p(sk), p(ek), n_tiles, sk.shape[1],
                              tile, p(packed), p(dep_packed), Dp)

    run_new = lambda: dk._deposit_tile_cuda(sk, ek, packed, dep_packed)
    plain = dk.deposit_tile_plain(sk, ek, packed, dep_packed)
    witness = dk.deposit_tile_plain(sk, ek, packed, dep_packed, sum_dtype=torch.float64)
    rec = dict(name=name, kernel="deposit_tile", tile=tile, lanes_per_tile=lane_stats(lanes),
               pairs=int(lanes.sum()) * tile, taken=int(plain[:, 0].sum()),
               geometry=asdict(dk.deposit_geometry(tile)),
               **against_witness(run_new(), run_old(), plain, witness))
    return timed(rec, run_old, run_new, reps)


def block_case(name, depo, hp, deps, parent, reps):
    packed, dep_packed, prep, dkeys, n_tiles, Dp = layout(depo, hp, deps, depo.wchunk)
    wt, blk, wcmp, overflow, _ = depo.work_list(prep, dkeys, n_tiles, Dp)
    dev, c_pad, p = packed.device, packed.shape[0], cuda_build.ptr
    tile, wchunk = depo.tile, depo.wchunk

    def run_old():
        return parent.deposit("block", dev, c_pad, tile, p(wt), p(blk), p(wcmp), wt.shape[0],
                              wchunk, n_tiles, tile, p(packed), p(dep_packed), Dp)

    args = (wt, blk, wcmp, packed, dep_packed, tile, wchunk)
    run_new = lambda: dk._deposit_block_cuda(*args)
    plain = dk.deposit_block_plain(*args)
    witness = dk.deposit_block_plain(*args, sum_dtype=torch.float64)
    items = torch.bincount(wt.long()[wcmp != 0], minlength=n_tiles)
    rec = dict(name=name, kernel="deposit_block", tile=tile,
               lanes_per_tile=lane_stats(items * wchunk),
               pairs=int(wcmp.sum()) * wchunk * tile, taken=int(plain[:, 0].sum()),
               overflow=int(overflow), geometry=asdict(dk.deposit_geometry(tile)),
               **against_witness(run_new(), run_old(), plain, witness))
    return timed(rec, run_old, run_new, reps)


def stream_case(name, depo, hp, deps, parent, reps):
    packed, dep_packed, prep, dkeys, n_tiles, Dp = layout(depo, hp, deps, depo.chunk)
    sk, ek = depo._window_lanes(prep, dkeys, n_tiles)
    itf, itab, starts, ends, overflow = depo.stream_items(sk, ek, n_tiles, Dp)
    wa, wb = lk.stream_mask(itf, itab)
    n_items = int(ends.max())
    lanes = (torch.clamp(wb, max=Dp) - torch.clamp(wa, min=0)).clamp_min(0)[:n_items]
    per_tile = torch.zeros(n_tiles, dtype=torch.int64, device=lanes.device)
    per_tile.index_add_(0, torch.repeat_interleave(
        torch.arange(n_tiles, device=lanes.device), (ends - starts).long()), lanes.long())
    dev, c_pad, tile, p = packed.device, packed.shape[0], depo.tile, cuda_build.ptr

    def run_old():
        return parent.deposit("stream", dev, c_pad, tile, p(itf), p(itab), p(starts), p(ends),
                              n_tiles, tile, p(packed), p(dep_packed), Dp)

    args = (itf, itab, starts, ends, packed, dep_packed)
    run_new = lambda: lk._deposit_stream_cuda(*args)
    plain = lk.deposit_stream_plain(*args)
    witness = lk.deposit_stream_plain(*args, sum_dtype=torch.float64)
    rec = dict(name=name, kernel="deposit_stream", tile=tile, items=n_items,
               lanes_per_tile=lane_stats(per_tile), pairs=int(lanes.sum()) * tile,
               taken=int(plain[:, 0].sum()), overflow=int(overflow),
               geometry=asdict(dk.deposit_geometry(tile)),
               **against_witness(run_new(), run_old(), plain, witness))
    return timed(rec, run_old, run_new, reps)


def lane_case(name, r, parent, reps):
    """Kernel #3 on the train round (chip_smoke.py phase 6)."""
    depo, packed, dep_packed = r["depo"], r["packed"], r["dep_packed"]
    lo, hi, wa, wb, overflow = depo.forward_items(r["sk"], r["ek"], r["n_tiles"], r["Dp"])
    n_items = int(hi.max())
    lanes = (wb - wa).clamp_min(0)
    tile = depo.tile
    args = (lo, hi, wa, wb, packed, dep_packed)
    run_old = lambda: parent.lane(*args)
    run_new = lambda: lk._deposit_lane_cuda(*args)
    plain = lk.deposit_lane_plain(*args)
    witness = lk.deposit_lane_plain(*args, sum_dtype=torch.float64)
    rec = dict(name=name, kernel="deposit_lane", tile=tile, items=n_items,
               lanes_per_item=lane_stats(lanes[:n_items]), items_per_tile=lane_stats(hi - lo),
               lanes_per_tile=lane_stats(per_run(lo, hi, lanes)),
               pairs=int(lanes[:n_items].sum()) * tile, taken=int(plain[:, 0].sum()),
               overflow=int(overflow), items_per_block=lk.LANE_ITEMS_PER_BLOCK,
               parts=int(lk.run_parts(lo, hi, lk.LANE_ITEMS_PER_BLOCK, wa.shape[0])[1][-1]),
               geometry=asdict(dk.deposit_geometry(tile, lk.LANE_GRID_SPLITS)),
               **against_witness(run_new(), run_old(), plain, witness))
    return timed(rec, run_old, run_new, reps)


def compare_flux(got, want):
    """Max relative and absolute distance of (3, Dp) lane sums."""
    d = (got - want).abs()
    rel = float((d / want.abs().clamp_min(1e-6)).max())
    return dict(max_rel_flux=rel, max_abs=float(d.max()), ok=rel <= cs.DEPOSIT_FLUX_RTOL)


def lane_bwd_case(name, r, parent, reps):
    """Kernel #4 on the train round with a seeded cotangent (chip_smoke.py
    phase 7); the new kernel's two calls must agree bit for bit."""
    depo, packed, dep_packed = r["depo"], r["packed"], r["dep_packed"]
    run_lo, run_hi, wt, wa, wb = depo.backward_items(r["sk"], r["ek"], r["n_tiles"], r["Dp"])
    gen = torch.Generator(device=packed.device).manual_seed(4)
    u = torch.rand((packed.shape[0], 3), generator=gen, device=packed.device)
    n_items = int(run_hi.max())
    lanes = (wb - wa).clamp_min(0)
    tile, chunk = depo.tile, depo.chunk
    args = (run_lo, run_hi, wt, wa, wb, packed, u, dep_packed, tile)
    run_old = lambda: parent.lane_bwd(*args, chunk)
    run_new = lambda: lk._deposit_lane_bwd_cuda(*args, chunk)
    plain = lk.deposit_lane_bwd_plain(*args)
    witness = lk.deposit_lane_bwd_plain(*args, sum_dtype=torch.float64)
    new, old = run_new(), run_old()
    repeat = bool(torch.equal(new, run_new()))
    geom = lk.lane_bwd_geometry(tile, chunk)
    rec = dict(name=name, kernel="deposit_lane_bwd", tile=tile, chunk=chunk, items=n_items,
               lanes_per_item=lane_stats(lanes[:n_items]),
               items_per_chunk=lane_stats(run_hi - run_lo),
               lanes_per_chunk=lane_stats(per_run(run_lo, run_hi, lanes)),
               pairs=int(lanes[:n_items].sum()) * tile, geometry=asdict(geom),
               items_per_block=lk.LANE_BWD_ITEMS_PER_BLOCK, parts=int(lk.run_parts(
                   run_lo, run_hi, lk.LANE_BWD_ITEMS_PER_BLOCK, wt.shape[0])[1][-1]),
               new_vs_f64=compare_flux(new, witness), old_vs_f64=compare_flux(old, witness),
               plain_vs_f64=compare_flux(plain, witness), new_vs_plain=compare_flux(new, plain),
               new_repeats_bitwise=repeat, old_repeats_bitwise=bool(torch.equal(old, run_old())))
    rec["new_vs_f64"]["ok"] = rec["new_vs_f64"]["ok"] and repeat
    return timed(rec, run_old, run_new, reps)


def newton_case(name, call, parent, reps):
    """Both Newton versions against the plain twin (every output equal) and
    against each other in time."""
    org, dir, ctrl = call
    iters = cs.BENCH["newton_iters"]
    run_old = lambda: parent.newton(org, dir, ctrl, iters, cs.RESTARTS)
    run_new = lambda: nk._solve_cuda(org, dir, ctrl, iters, cs.RESTARTS, nk.M_EPS)
    want = nk.solve_plain(org, dir, ctrl, iters, cs.RESTARTS)
    equal = lambda got: all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    gate = nk.open_pairs(org, dir, ctrl)
    rec = dict(name=name, kernel="newton", rays=org.shape[0], patches=ctrl.shape[0],
               restarts=cs.RESTARTS, hits=int(want[4].sum()), open_pairs=int(gate.sum()),
               schedule=nk.drain_schedule(gate, cs.RESTARTS), new_equals_plain=equal(run_new()),
               old_equals_plain=equal(run_old()))
    rec["ok"] = rec["new_equals_plain"] and rec["hits"] > 0
    return timed(rec, run_old, run_new, reps)


def newton_pass_case(name, calls, parent, reps):
    """Every Newton call of one pass, in order, timed as one unit (the
    kernel's device time a pass); the two versions' outputs equal call by
    call."""
    iters = cs.BENCH["newton_iters"]
    run_old = lambda: [parent.newton(o, d, c, iters, cs.RESTARTS) for o, d, c in calls]
    run_new = lambda: [nk._solve_cuda(o, d, c, iters, cs.RESTARTS, nk.M_EPS)
                       for o, d, c in calls]
    same = all(all(bool(torch.equal(a, b)) for a, b in zip(x, y))
               for x, y in zip(run_old(), run_new()))
    rec = dict(name=name, kernel="newton", calls=len(calls),
               rays=sum(c[0].shape[0] for c in calls), new_equals_old=same, ok=same)
    return timed(rec, run_old, run_new, reps)


def sass_loops(lib: Path, out_dir: Path) -> dict:
    """Dump ``cuobjdump -sass`` of ``lib``; per kernel, the instruction
    counts of its loops (a backward branch closes each)."""
    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    (out_dir / f"{lib.stem}.sass").write_text(text)
    res = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)
        addr = [int(a, 16) for a, _ in ins]
        loops = []
        for i, (a, body) in enumerate(ins):
            tgt = re.search(r"0x([0-9a-f]+)", body) if "BRA" in body else None
            if tgt and int(tgt.group(1), 16) < addr[i]:
                lo = int(tgt.group(1), 16)
                seg = [b for x, b in ins if lo <= int(x, 16) <= addr[i]]
                kinds = {}
                for b in seg:
                    op = re.sub(r"^@!?U?P\w+\s+", "", b.strip()).split()[0].split(".")[0]
                    kinds[op] = kinds.get(op, 0) + 1
                loops.append(dict(start=hex(lo), end=hex(addr[i]), instructions=len(seg),
                                  ops=dict(sorted(kinds.items(), key=lambda kv: -kv[1]))))
        res[name] = loops
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", type=Path, required=True,
                    help="the JSON record; the --sass dumps go beside it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    parent = Parent(args.parent)
    current = {"newton": nk.KERNEL, "tile": dk.KERNEL, "block": dk.BLOCK_KERNEL,
               "stream": lk.STREAM, "lane": lk.FORWARD, "lane_bwd": lk.BACKWARD}
    builds = [(f"{v}_{n}", k) for v, ks in (("old", parent.kernels), ("new", current))
              for n, k in ks.items()]
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda b: cuda_build.build(b[1].source, b[1].csrc_dir), builds))
    for (label, _), lib in zip(builds, libs):
        regs = [ln.strip() for ln in lib.with_suffix(".ptxas.txt").read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {label}: {regs}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    result = dict(card=card, device=torch.cuda.get_device_name(0), parent=str(args.parent),
                  cases=[])
    if args.sass:
        result["sass"] = {label: sass_loops(lib, args.out.parent)
                          for (label, _), lib in zip(builds, libs)}

    def add(case):
        result["cases"].append(case)
        print(json.dumps(case), flush=True)

    hp, deps, xy, calls = bench_round(device)
    add(newton_case("photon_segment", calls[3], parent, args.reps))
    del calls
    pass_calls = render_pass_calls(device)
    add(newton_case("render_pass_largest", max(pass_calls, key=lambda c: c[0].shape[0]),
                    parent, args.reps))
    add(newton_pass_case("render_pass_all", pass_calls, parent, args.reps))
    del pass_calls
    add(tile_case("bench512_tile256", dk.make_tile_deposit(tile=256, **xy), hp, deps, parent,
                  args.reps))
    add(stream_case("bench512_stream128", lk.DepositStream(**cs.STREAM, **xy), hp, deps,
                    parent, args.reps))
    del hp, deps

    r = cs.train_round(device)
    add(lane_case("train256_lane256", r, parent, args.reps))
    add(lane_bwd_case("train256_lane_bwd256", r, parent, args.reps))
    del r

    cfg, depo, hp, st, deps = cs.preset_round(device)
    add(block_case("ref1024_block1024", depo, hp, deps, parent, args.reps))
    # The CLI's --deposit tile at a 1024^2 canvas (cli.py: make_backends).
    tile512 = dk.DepositTile(tile=512, chunk=2048, bucket2d=False, **preset_bounds(cfg, device))
    add(tile_case("ref1024_tile512", tile512, hp, deps, parent, args.reps))
    result["card"] = cs.card_line()
    args.out.write_text(json.dumps(result, indent=1))
    ok = all(c["ok"] if c["kernel"] == "newton" else c["new_vs_f64"]["ok"]
             for c in result["cases"])
    print(f"wrote {args.out}; new kernels agree with their plain twins: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
