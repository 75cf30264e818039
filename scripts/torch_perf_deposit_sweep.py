#!/usr/bin/env python3
"""JAX's 36 deposit configurations at bench shapes, on the PyTorch/CUDA
port, after ``scripts/perf_deposit_sweep.py``.

    python3 scripts/torch_perf_deposit_sweep.py [--only 0,1,...] [--d 1835008]
        [--c 340787] [--reps 8] [--platform cpu] [--out docs/DEPOSIT_SWEEP_PORT.json]

Times the whole per-round deposit call (sort, work list, kernel, unpack)
of every configuration of ``scripts/perf_deposit_sweep.py:106-172``, in
its order and under its names, on JAX's inputs: points on the reference
scene's surfaces (``scene_points``, a copy of JAX's) drawn from
``np.random.default_rng(0)`` in JAX's order, D = 14 x 131072 deposits (80%
valid) against C = 512^2 x 1.3 hit points, every hit point valid with
r2 = 2; the hit points' normals, which JAX leaves 0 (so that no pair
passes the normal test and every count is 0), are drawn after JAX's
draws, and their weights, 0 in JAX's, are 1 (so the unpacked rows' flux is
not 0).  The port's classes stand for JAX's: ``DepositBlock`` (kernel #5)
for ``PallasDeposit``, ``DepositTile`` (#2) for ``PallasDepositTile``,
``DepositStream`` (#6) for ``PallasDepositStream`` and ``DepositZTile``
(#2 over coarse-z windows) for ``PallasDepositZTile``.  Packed
configurations go through ``pack_state`` / ``packed_call``, as JAX's do.
``nbuf`` is the depth of the TPU kernel's DMA ring; the card's stream
kernel does not read it (its ring is ``csrc/deposit_stage.cuh``'s), so the
configurations that differ only in ``nbuf`` run the same code and are each
timed all the same.

Per configuration: device ms (CUDA events; None on the CPU) and wall ms,
medians of ``--reps`` calls after a warm one (``core/device.call_times``);
``overflow``, ``n_tiles``, ``n_buckets``, and ``items`` where JAX's class
has ``work_items`` (every class but ``PallasDeposit``: JAX's tile classes
inherit it from its lane class); its counts and flux against its plain
twin's (``plain_twins``: the same call with the kernel's wrapper swapped for
its plain version summing in float64, so the same work list on the same
inputs), counts exactly and flux to TWIN_FLUX_RTOL; and whether its
per-hit-point counts equal those of ``tile1d_t128_ch1024``, the first row
with no work cap (of the first uncapped row selected, without it).  Every
configuration computes the same counts on the same input, so this is a
free check across rows; a capped row whose ``overflow`` is non-zero dropped
work by design and says so instead (its twin drops the same work).
``--only`` is JAX's ``RT3_SWEEP`` (indices into the list; a selection with
no uncapped row is refused), ``--d`` / ``--c`` its ``RT3_SWEEP_D`` / ``_C``.
Writes the record with the device, the card's name and power limit and
``reduced``; exits 1 when a configuration fails, disagrees with its twin or
(uncapped) differs from the reference's counts.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raytrace3_tpu_torch.core.device import (call_times, record_fields,  # noqa: E402
                                             resolve_device)

DEFAULTS = dict(d=14 * 131072, c=int(512 * 512 * 1.3), reps=8)
#: The row every other row's counts are held to.
REFERENCE = "tile1d_t128_ch1024"
#: A row's raw flux against its float64-summed plain twin's, relative to
#: the slot's flux (``chip_smoke.py``'s DEPOSIT_FLUX_RTOL).
TWIN_FLUX_RTOL = 1e-5


def scene_points(rng, n):
    """Points on the reference scene's surfaces (Scene.h:116-156 geometry):
    ``scripts/perf_deposit_sweep.py:33-54``, the same draws."""
    kind = rng.integers(0, 6, n)
    p = np.zeros((n, 3), np.float32)
    u, v = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    p[kind == 0] = np.stack([np.full((kind == 0).sum(), 1.0),
                             u[kind == 0] * 81.6, v[kind == 0] * 170],
                            1)  # left wall
    p[kind == 1] = np.stack([np.full((kind == 1).sum(), 99.0),
                             u[kind == 1] * 81.6, v[kind == 1] * 170], 1)
    m = kind == 2  # floor (the caustics surface - heaviest)
    p[m] = np.stack([u[m] * 98 + 1, np.zeros(m.sum()), v[m] * 170], 1)
    m = kind == 3  # ceiling
    p[m] = np.stack([u[m] * 98 + 1, np.full(m.sum(), 81.6), v[m] * 170], 1)
    m = kind == 4  # back wall
    p[m] = np.stack([u[m] * 98 + 1, v[m] * 81.6, np.zeros(m.sum())], 1)
    m = kind == 5  # sphere-ish cluster near the glass sphere
    th, ph = u[m] * np.pi, v[m] * 2 * np.pi
    p[m] = np.stack([73 + 16.5 * np.sin(th) * np.cos(ph),
                     16.5 + 16.5 * np.cos(th),
                     88 + 16.5 * np.sin(th) * np.sin(ph)], 1)
    return p


def inputs(d: int, c: int, device):
    """(deposits, hit points) from ``default_rng(0)``: JAX's draws, then
    the hit points' normals."""
    from raytrace3_tpu_torch.core.types import Deposits, make_hitpoints

    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=device)
    dep = Deposits(pos=t(scene_points(rng, d)),
                   n=t(rng.normal(size=(d, 3)).astype(np.float32)),
                   flux=t(rng.uniform(0, 1, (d, 3)).astype(np.float32)),
                   valid=t(rng.uniform(size=d) < 0.8))
    hp = make_hitpoints(c, 2.0, device)
    hp = hp.replace(pos=t(scene_points(rng, c)),
                    valid=torch.ones((c,), dtype=torch.bool, device=device))
    # JAX leaves the hit points' normals 0, which fails every pair's normal
    # test, so every count would be 0: drawn after JAX's draws, they make
    # the rows' counts a check on real pairs.  Its weights 0 would make the
    # unpacked rows' flux (wgt * flux / pi) 0: 1 here, for the twin's check.
    return dep, hp.replace(n=t(rng.normal(size=(c, 3)).astype(np.float32)),
                           wgt=torch.ones((c, 3), dtype=torch.float32, device=device))


def configs():
    """JAX's list, ``(name, class name, keywords)``, in its order."""
    bounds = dict(x_lo=-4.0, x_hi=104.0, z_lo=-4.0, z_hi=184.0)
    b1 = dict(x_lo=-4.0, x_hi=104.0)
    T, S, Z, B = "DepositTile", "DepositStream", "DepositZTile", "DepositBlock"
    out = [
        ("1d_t512_wc1024_W16k", B, dict(tile=512, wchunk=1024, work_cap=16384)),
        ("tile1d_t128_ch1024", T, dict(tile=128, chunk=1024, bucket2d=False, **b1)),
        ("str1d_t128_ch1024_n4", S, dict(tile=128, chunk=1024, nbuf=4, work_cap=65536,
                                         bucket2d=False, **b1)),
        ("str1d_t128_ch1024_n8", S, dict(tile=128, chunk=1024, nbuf=8, work_cap=65536,
                                         bucket2d=False, **b1)),
        ("str1d_t128_ch512_n8", S, dict(tile=128, chunk=512, nbuf=8, work_cap=98304,
                                        bucket2d=False, **b1)),
        ("str2d_t64_ch1024_n8_merge", S, dict(tile=64, chunk=1024, nbuf=8, work_cap=65536,
                                              **bounds)),
        ("str1d_t128_ch1024_n8_packed", S, dict(tile=128, chunk=1024, nbuf=8,
                                                work_cap=65536, bucket2d=False, packed=True,
                                                **b1)),
        ("tile1d_t512_ch1024_packed", T, dict(tile=512, chunk=1024, bucket2d=False,
                                              packed=True, **b1)),
        ("tile1d_t128_ch1024_packed", T, dict(tile=128, chunk=1024, bucket2d=False,
                                              packed=True, **b1)),
    ]
    for zc in (11.3, 16.0, 22.6, 32.0, 45.0):
        for t_, ch in ((128, 1024), (128, 512), (256, 1024), (64, 512)):
            out.append((f"ztile_zc{zc}_t{t_}_ch{ch}_packed", Z,
                        dict(tile=t_, chunk=ch, z_coarse=zc, packed=True, **bounds)))
    for t_, ch in ((128, 2048), (256, 2048), (128, 1536)):
        out.append((f"tile1d_t{t_}_ch{ch}_packed", T,
                    dict(tile=t_, chunk=ch, bucket2d=False, packed=True, **b1)))
    for zc, t_, ch in ((8.0, 128, 1024), (11.3, 256, 2048), (11.3, 384, 1024)):
        out.append((f"ztile_zc{zc}_t{t_}_ch{ch}_packed", Z,
                    dict(tile=t_, chunk=ch, z_coarse=zc, packed=True, **bounds)))
    out.append(("tile1d_t512_ch2048_packed", T, dict(tile=512, chunk=2048, bucket2d=False,
                                                     packed=True, **b1)))
    return out


def make_deposit(cls_name: str, kw: dict):
    """(the port's deposit, packed, JAX's nbuf or None) of one row."""
    from raytrace3_tpu_torch.ops import deposit_kernel, lane_kernel

    kw = dict(kw)
    packed, nbuf = kw.pop("packed", False), kw.get("nbuf")
    cls = getattr(deposit_kernel, cls_name, None) or getattr(lane_kernel, cls_name)
    return cls(**kw), packed, nbuf


def work_items(depo, hp, dep, prep):
    """JAX's ``work_items`` where its class has one: every class but the
    block deposit's (``PallasDeposit``).  JAX's tile classes inherit it
    from ``PallasDepositLane``; the port's ``DepositLane.work_items`` is the
    same count on the same windows, applied to them alike."""
    from raytrace3_tpu_torch.ops.deposit_kernel import DepositBlock
    from raytrace3_tpu_torch.ops.lane_kernel import DepositLane

    if isinstance(depo, DepositBlock):
        return None
    return int(DepositLane.work_items(depo, hp, dep, prep))


@contextlib.contextmanager
def plain_twins():
    """Inside, the deposit wrappers the classes call (kernels #2, #5, #6)
    are their plain twins summing in float64: the same work list on the
    same inputs, no kernel."""
    from raytrace3_tpu_torch.ops import deposit_kernel, lane_kernel

    f64 = lambda plain: lambda *a: plain(*a, sum_dtype=torch.float64)
    swaps = [(deposit_kernel, "deposit_tile", f64(deposit_kernel.deposit_tile_plain)),
             (deposit_kernel, "deposit_block", f64(deposit_kernel.deposit_block_plain)),
             (lane_kernel, "deposit_stream", f64(lane_kernel.deposit_stream_plain))]
    originals = [getattr(m, name) for m, name, _ in swaps]
    for m, name, twin in swaps:
        setattr(m, name, twin)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(swaps, originals):
            setattr(m, name, fn)


def hold_twin(out, twin) -> dict:
    """A row's (count, raw flux) against its plain twin's on the same
    inputs: count mismatches (exact) and the largest flux error relative
    to the twin's slot flux (TWIN_FLUX_RTOL)."""
    cnt_mismatch = int((out[0] != twin[0]).sum())
    rel = float(((out[1] - twin[1]).abs() / twin[1].abs().clamp_min(1e-6)).max())
    return {"twin_count_mismatch": cnt_mismatch, "twin_flux_rel": rel,
            "twin_pairs": int(twin[0].sum()),
            "holds_twin": cnt_mismatch == 0 and rel <= TWIN_FLUX_RTOL}


def run_row(name: str, cls_name: str, kw: dict, dep, hp, reps: int, device):
    """(the row's record, its per-hit-point counts)."""
    from raytrace3_tpu_torch.ops.cuda_build import launch_counts, launches_since

    depo, packed, nbuf = make_deposit(cls_name, kw)
    prep = depo.prepare(hp)
    if packed:
        r2_pad, _ = depo.pack_state(hp, prep)
        call = lambda: depo.packed_call(r2_pad, dep, prep)
    else:
        call = lambda: depo(hp, dep, prep=prep)
    before = launch_counts()
    out = call()
    cnt = depo.unpack_state(prep, out[0])[0] if packed else out[0]
    dev_ms, wall_ms = call_times(call, reps, device)
    launches = launches_since(before)
    with plain_twins():
        twin = call()
    rec = {"cfg": name, "class": cls_name, "device_ms": dev_ms, "wall_ms": wall_ms,
           "overflow": int(out[2]), "n_tiles": depo._c_pad(hp.capacity) // depo.tile,
           "n_buckets": depo.n_buckets, "launches": launches, **hold_twin(out, twin)}
    items = work_items(depo, hp, dep, prep)
    if items is not None:
        rec["items"] = items
    if nbuf is not None:
        rec["nbuf"] = nbuf
    return rec, cnt


def sweep(rows, d: int, c: int, reps: int, device) -> dict:
    """Every row's record, and each one's counts held to the reference's."""
    dep, hp = inputs(d, c, device)
    names = [n for n, _, _ in rows]
    ref_name = REFERENCE if REFERENCE in names else next(
        (n for n, cls, kw in rows if "work_cap" not in kw), None)
    records, counts = [], {}
    for name, cls_name, kw in rows:
        try:
            rec, counts[name] = run_row(name, cls_name, kw, dep, hp, reps, device)
        except (RuntimeError, ValueError) as e:
            rec = {"cfg": name, "class": cls_name, "error": str(e)[-2000:]}
        records.append(rec)
        dev = "n/a" if rec.get("device_ms") is None else f"{rec['device_ms']:.3f}"
        print(f"{name:34s} " + (f"error {rec['error'][:200]}" if "error" in rec else
                                f"device {dev} ms, wall {rec['wall_ms']:.3f} ms, overflow "
                                f"{rec['overflow']}, items {rec.get('items')}, twin: "
                                f"{rec['twin_count_mismatch']} count mismatches, flux "
                                f"{rec['twin_flux_rel']:.3g}"),
              file=sys.stderr, flush=True)
    ref = counts.get(ref_name)
    for rec in records:
        if "error" in rec or ref is None:
            continue
        rec["counts_equal_reference"] = bool(torch.equal(counts[rec["cfg"]], ref))
    ok = all("error" not in r and r["holds_twin"]
             and (r.get("counts_equal_reference") or r["overflow"] > 0) for r in records)
    return {"rows": records, "counts_reference": ref_name, "valid_deposits":
            int(dep.valid.sum()), "pairs_counted": None if ref is None else int(ref.sum()),
            "all_rows_ok": ok}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma list of row indices (JAX's RT3_SWEEP; default: all)")
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "DEPOSIT_SWEEP_PORT.json"))
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    rows = configs()
    if args.only:
        keep = {int(i) for i in args.only.split(",")}
        rows = [r for i, r in enumerate(rows) if i in keep]
        if not any("work_cap" not in kw for _, _, kw in rows):
            ap.error(f"--only {args.only} selects no uncapped row, so no row's counts "
                     "would be held to another's; add one (e.g. 1)")
    print(f"# D={args.d} C={args.c} device={device.type}", file=sys.stderr, flush=True)
    res = sweep(rows, args.d, args.c, args.reps, device)
    reduced = [f"{k} {v} -> {getattr(args, k)}" for k, v in DEFAULTS.items()
               if getattr(args, k) != v]
    if args.only:
        reduced.append(f"configurations {len(configs())} -> {len(rows)} (--only {args.only})")
    record = {"what": "scripts/perf_deposit_sweep.py's deposit configurations on the port",
              "d": args.d, "c": args.c, "reps": args.reps, **res,
              "nbuf": "the TPU kernel's DMA ring depth; the card's stream kernel does not "
                      "read it (csrc/deposit_stage.cuh's ring), so rows differing only in "
                      "nbuf run the same code",
              "torch": torch.__version__, **record_fields(device), "reduced": reduced}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    for r in record["rows"]:
        print(json.dumps(r), flush=True)
    return 0 if res["all_rows_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
