#!/usr/bin/env python3
"""Time the tile deposit (#2) and block deposit (#5) CUDA kernels against
an earlier version of the same kernels, in turns, on the rounds of the
port's paths.  Needs one NVIDIA GPU and nvcc.

    python3 scripts/perf_deposit_kernels.py --parent DIR [--reps 5]
        [--sass] [--out chiprun_out/perf_deposit_kernels.json]

``DIR`` holds the earlier ``deposit_tile.cu``, ``deposit_block.cu`` and
their headers (``git archive`` of the parent commit's
``raytrace3_tpu_torch/csrc`` unpacked there).  Its C entry points take the
launch geometry as the current ones do when ``DIR`` has
``deposit_stage.cuh`` (they get the current geometry), and end at ``out``
otherwise (the first versions, one block a tile).

Rounds (the inputs chip_smoke.py builds): the bench round (512^2 hit
points, 16 x 131072 photons' first round, tile 256: phase 3), the
reference1024 round through ``DepositBlock`` as the CLI builds it (tile
1024, wchunk 1024, work cap 65536: phase 10), and the same 1024^2 round
through ``DepositTile`` at tile 512 (the CLI's ``--deposit tile`` there).
For each: the lanes per tile; the new and old kernels and the float32
plain twin against the plain twin with its flux summed in float64 (counts
exact, flux rtol 1e-5 for the kernels); and CUDA-event medians of
``--reps`` runs in the order old, new, new, old.  ``--sass`` writes
``cuobjdump -sass`` of both versions and counts the instructions of each
inner loop.
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

#: The first versions' entry points end at ``out``.
LEGACY_TILE_ARGS = dk.KERNEL.argtypes[:9]
LEGACY_BLOCK_ARGS = dk.BLOCK_KERNEL.argtypes[:11]


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
    """The earlier tile and block kernels of ``csrc_dir``."""

    def __init__(self, csrc_dir: Path):
        self.legacy = not (csrc_dir / "deposit_stage.cuh").exists()
        tile_args = LEGACY_TILE_ARGS if self.legacy else dk.KERNEL.argtypes
        block_args = LEGACY_BLOCK_ARGS if self.legacy else dk.BLOCK_KERNEL.argtypes
        self.tile = cuda_build.CudaKernel("deposit_tile.cu", "rt3_deposit_tile", tile_args,
                                          csrc_dir)
        self.block = cuda_build.CudaKernel("deposit_block.cu", "rt3_deposit_block", block_args,
                                           csrc_dir)

    def launch(self, kernel, dev, c_pad, tile, *args):
        """``out`` of ``kernel`` on ``args`` (the arguments before ``out``)."""
        out = torch.empty((c_pad, 8), dtype=torch.float32, device=dev)
        if self.legacy:
            kernel.launch(dev, *args, cs_ptr(out))
        else:
            gargs, scratch = dk._geometry_args(tile, c_pad, dev)
            kernel.launch(dev, *args, cs_ptr(out), *gargs)
            del scratch     # the stream orders its reuse after the kernel
        return out


def bench_round(device):
    """(hit points, deposits, tile deposit) of chip_smoke.py phase 3."""
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.photon import photon_trace_regen

    cfg, scene, hp, _ = cs.bench_hitpoints(device)
    photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
    gen = torch.Generator(device=device).manual_seed(1)
    deps, _, _ = photon_trace_regen(photon_scene, gen, scene.light_pos, scene.light_color,
                                    cfg.photons_per_round, None, cfg.max_depth,
                                    newton_fn=make_newton(cfg.newton_iters, cs.RESTARTS))
    b = dk.world_bounds_from_scene(scene, extra_points=[cs.BASE])
    return hp, deps, {k: b[k] for k in cs.BOUNDS}


def preset_bounds(cfg, device) -> dict:
    from raytrace3_tpu_torch.render.driver import build_scene

    b = dk.world_bounds_from_scene(build_scene(cfg, device), extra_points=[cs.BASE])
    return {k: b[k] for k in cs.BOUNDS}


def tile_inputs(depo, hp, deps):
    prep = depo.prepare(hp)
    r2_pad, _ = depo.pack_state(hp, prep)
    packed = prep.packed.clone()
    packed[:, 6] = r2_pad
    n_tiles = packed.shape[0] // depo.tile
    dkeys, dep_packed, Dp = depo._dep_sorted(deps, depo.chunk)
    sk, ek = depo._window_lanes(prep, dkeys, n_tiles)
    sk, ek = sk.to(torch.int32).contiguous(), ek.to(torch.int32).contiguous()
    lanes = (torch.clamp(ek.long(), max=Dp) - torch.clamp(sk.long(), min=0)).clamp_min(0).sum(1)
    return dict(sk=sk, ek=ek, packed=packed, dep_packed=dep_packed, n_tiles=n_tiles,
                lanes=lanes, pairs=int(lanes.sum()) * depo.tile)


def block_inputs(depo, hp, deps):
    prep = depo.prepare(hp)
    r2_pad, _ = depo.pack_state(hp, prep)
    packed = prep.packed.clone()
    packed[:, 6] = r2_pad
    n_tiles = packed.shape[0] // depo.tile
    dkeys, dep_packed, Dp = depo._dep_sorted(deps, depo.wchunk)
    wt, blk, wcmp, overflow, total = depo.work_list(prep, dkeys, n_tiles, Dp)
    items = torch.bincount(wt.long()[wcmp != 0], minlength=n_tiles)
    return dict(wt=wt, blk=blk, wcmp=wcmp, packed=packed, dep_packed=dep_packed,
                n_tiles=n_tiles, lanes=items * depo.wchunk, overflow=int(overflow),
                pairs=int(wcmp.sum()) * depo.wchunk * depo.tile)


def lane_stats(lanes):
    x = lanes.double()
    return dict(tiles=int(x.numel()), max=int(x.max()), mean=float(x.mean()),
                p99=float(torch.quantile(x, 0.99)), heaviest_share=float(x.max() / x.sum()))


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


def turns(old, new, reps):
    """old, new, new, old: CUDA-event medians of ``reps`` runs each."""
    o1, n1, n2, o2 = (cs.cuda_ms(f, reps) for f in (old, new, new, old))
    return dict(old=[o1, o2], new=[n1, n2], old_ms=float(np.median([o1, o2])),
                new_ms=float(np.median([n1, n2])))


def tile_case(name, depo, hp, deps, parent, reps):
    x = tile_inputs(depo, hp, deps)
    sk, ek, packed, dep_packed = x["sk"], x["ek"], x["packed"], x["dep_packed"]
    dev, c_pad, Dp = packed.device, packed.shape[0], dep_packed.shape[1]
    tile = depo.tile

    def run_old():
        return parent.launch(parent.tile, dev, c_pad, tile, cs_ptr(sk), cs_ptr(ek),
                             x["n_tiles"], sk.shape[1], tile, cs_ptr(packed),
                             cs_ptr(dep_packed), Dp)

    run_new = lambda: dk._deposit_tile_cuda(sk, ek, packed, dep_packed)
    plain = dk.deposit_tile_plain(sk, ek, packed, dep_packed)
    witness = dk.deposit_tile_plain(sk, ek, packed, dep_packed, sum_dtype=torch.float64)
    rec = dict(name=name, kernel="deposit_tile", tile=tile, lanes_per_tile=lane_stats(x["lanes"]),
               pairs=x["pairs"], taken=int(plain[:, 0].sum()),
               geometry=asdict(dk.deposit_geometry(tile)),
               **against_witness(run_new(), run_old(), plain, witness))
    return timed(rec, run_old, run_new, reps)


def timed(rec, run_old, run_new, reps):
    with ClockSampler() as clk:
        rec["times"] = turns(run_old, run_new, reps)
    rec["clock"] = clk.result
    return rec


def block_case(name, depo, hp, deps, parent, reps):
    x = block_inputs(depo, hp, deps)
    wt, blk, wcmp, packed, dep_packed = (x[k] for k in ("wt", "blk", "wcmp", "packed",
                                                        "dep_packed"))
    dev, c_pad, Dp = packed.device, packed.shape[0], dep_packed.shape[1]
    tile, wchunk = depo.tile, depo.wchunk

    def run_old():
        return parent.launch(parent.block, dev, c_pad, tile, cs_ptr(wt), cs_ptr(blk),
                             cs_ptr(wcmp), wt.shape[0], wchunk, x["n_tiles"], tile,
                             cs_ptr(packed), cs_ptr(dep_packed), Dp)

    args = (wt, blk, wcmp, packed, dep_packed, tile, wchunk)
    run_new = lambda: dk._deposit_block_cuda(*args)
    plain = dk.deposit_block_plain(*args)
    witness = dk.deposit_block_plain(*args, sum_dtype=torch.float64)
    rec = dict(name=name, kernel="deposit_block", tile=tile, lanes_per_tile=lane_stats(x["lanes"]),
               pairs=x["pairs"], taken=int(plain[:, 0].sum()), overflow=x["overflow"],
               geometry=asdict(dk.deposit_geometry(tile)),
               **against_witness(run_new(), run_old(), plain, witness))
    return timed(rec, run_old, run_new, reps)


def cs_ptr(t):
    return cuda_build.ptr(t)


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
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "perf_deposit_kernels.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    parent = Parent(args.parent)
    kernels = [parent.tile, parent.block, dk.KERNEL, dk.BLOCK_KERNEL]
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda k: cuda_build.build(k.source, k.csrc_dir), kernels))
    for k, lib in zip(kernels, libs):
        regs = [ln.strip() for ln in lib.with_suffix(".ptxas.txt").read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {k.source} from {k.csrc_dir}: {regs}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    result = dict(card=card, device=torch.cuda.get_device_name(0), parent=str(args.parent),
                  cases=[])
    if args.sass:
        names = ["old_tile", "old_block", "new_tile", "new_block"]
        result["sass"] = {n: sass_loops(lib, args.out.parent) for n, lib in zip(names, libs)}
        print(json.dumps(result["sass"], indent=1), flush=True)

    hp, deps, xy = bench_round(device)
    result["cases"].append(tile_case("bench512_tile256", dk.make_tile_deposit(tile=256, **xy),
                                     hp, deps, parent, args.reps))
    print(json.dumps(result["cases"][-1]), flush=True)
    del hp, deps

    cfg, depo, hp, st, deps = cs.preset_round(device)
    result["cases"].append(block_case("ref1024_block1024", depo, hp, deps, parent, args.reps))
    print(json.dumps(result["cases"][-1]), flush=True)
    # The CLI's --deposit tile at a 1024^2 canvas (cli.py: make_backends).
    tile512 = dk.DepositTile(tile=512, chunk=2048, bucket2d=False,
                             **preset_bounds(cfg, device))
    result["cases"].append(tile_case("ref1024_tile512", tile512, hp, deps, parent, args.reps))
    print(json.dumps(result["cases"][-1]), flush=True)
    result["card"] = cs.card_line()
    args.out.write_text(json.dumps(result, indent=1))
    ok = all(c["new_vs_f64"]["ok"] for c in result["cases"])
    print(f"wrote {args.out}; new kernels agree with the float64-summed twins: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
