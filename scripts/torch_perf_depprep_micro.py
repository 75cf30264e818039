#!/usr/bin/env python3
"""The deposit's per-round prep on the card, a sort and a row permute,
after ``scripts/perf_depprep_micro.py``.

    python3 scripts/torch_perf_depprep_micro.py [--d 1835008] [--res 512]
        [--photons 131072] [--reps 16] [--platform cpu]
        [--out docs/DEPPREP_PORT.json]

JAX's candidates at its shapes: ``d`` int32 keys in [0, 2^20) and (d, 16)
float32 rows, both from ``default_rng(0)``, each a stable sort of the keys
and then

  a) a 16-column row gather,  b) a 12-column one,  c) an 8-column one,
  f) ``torch.take_along_dim`` on the 16 columns.

JAX's d and e (a variadic ``lax.sort`` carrying 9 or 12 payload columns)
have no single PyTorch counterpart and are recorded so.  One more
candidate ties them to the pipeline: the port's own prep
(``ops/deposit_kernel.DepositTile._dep_sorted``: ``torch.sort(dkey,
stable=True)``, then ``rows[order].T`` into ``dep_packed``) on the
deposits of one regen round of the bench (``bench_torch.BENCH`` at
``--res`` and ``--photons``, the Newton kernel on the card), held to its
row-gather twin (candidate a on the same keys and rows).  Each candidate
is timed in device ms (CUDA events) and wall ms, medians of ``reps``
calls.  The script exits 1 if an output differs from its twin's.  Writes
the record (``device``, ``card``, ``power_limit``, ``reduced``) to
``--out``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raytrace3_tpu_torch.core.device import (call_times, record_fields,  # noqa: E402
                                             resolve_device)

DEFAULTS = dict(d=14 * 131072, res=512, photons=131072)


def _sorted(k):
    return torch.sort(k, stable=True)


def a_rowgather16(k, c):
    ks, o = _sorted(k)
    return ks, c[o]


def b_rowgather12(k, c):
    ks, o = _sorted(k)
    return ks, c[:, :12][o]


def c_rowgather8(k, c):
    ks, o = _sorted(k)
    return ks, c[:, :8][o]


def f_take_along(k, c):
    ks, o = _sorted(k)
    return ks, torch.take_along_dim(c, o[:, None], dim=0)


CANDIDATES = {"a_rowgather16": a_rowgather16, "b_rowgather12": b_rowgather12,
              "c_rowgather8": c_rowgather8, "f_take_along": f_take_along}
#: JAX's candidates with no PyTorch counterpart of one call.
NO_COUNTERPART = {
    "d_varsort9": "JAX's variadic lax.sort carries 9 payload columns with the key; "
                  "torch.sort sorts one tensor and returns the permutation, so the payload "
                  "is a gather after it (candidates a-c)",
    "e_varsort12": "as d_varsort9, with 12 payload columns",
}


def check(ok: bool, what: str) -> None:
    """Raise ``AssertionError(what)`` unless ``ok`` (kept under -O)."""
    if not ok:
        raise AssertionError(what)


def synthetic(d: int, device):
    """JAX's inputs: (keys (d,) int32 in [0, 2^20), rows (d, 16) float32),
    from ``default_rng(0)`` in its order."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 20, d).astype(np.int32)
    cols = rng.normal(size=(d, 16)).astype(np.float32)
    return torch.as_tensor(keys, device=device), torch.as_tensor(cols, device=device)


def check_candidates(outs: dict) -> None:
    """Raise ``AssertionError`` unless every candidate's keys equal a's and
    its columns equal a's first columns."""
    ks, rows = outs["a_rowgather16"]
    for name, (k, r) in outs.items():
        check(torch.equal(k, ks), f"{name}: the sorted keys differ")
        check(torch.equal(r, rows[:, :r.shape[1]]), f"{name}: the rows differ")


def bench_round(res: int, photons: int, device):
    """(the bench's tile deposit, one regen round's deposits) at ``res``^2
    with ``photons`` a round: ``chip_smoke.py`` phase 2's round."""
    from bench_torch import BASE, BENCH, BOUNDS, RESTARTS, TILE
    from raytrace3_tpu_torch.ops.deposit_kernel import (make_tile_deposit,
                                                        world_bounds_from_scene)
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.photon import photon_trace_regen
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**dict(BENCH, width=res, height=res, photons_per_round=photons))
    scene = build_scene(cfg, device)
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    dep_fn = make_tile_deposit(tile=TILE, **{k: b[k] for k in BOUNDS})
    walk = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
    newton = make_newton(cfg.newton_iters, RESTARTS) if device.type == "cuda" else None
    gen = torch.Generator(device=device).manual_seed(1)
    deps, _, _ = photon_trace_regen(walk, gen, walk.light_pos, walk.light_color,
                                    cfg.photons_per_round, None, cfg.max_depth,
                                    newton_fn=newton)
    return dep_fn, deps


def check_prep(dep_fn, deps) -> dict:
    """The port's prep against its row-gather twin on ``deps``: the sorted
    keys equal, ``dep_packed``'s 9 rows the gathered rows transposed, its
    padding FAR positions and zeros.  Raises ``AssertionError``."""
    from raytrace3_tpu_torch.ops.deposit_kernel import FAR

    dkeys, packed, Dp = dep_fn._dep_sorted(deps, dep_fn.chunk)
    dkey, rows = dep_fn._dep_rows(deps)
    ks, gathered = a_rowgather16(dkey, rows)
    D = rows.shape[0]
    check(torch.equal(dkeys, ks), "prep: the sorted keys differ from the twin's")
    check(torch.equal(packed[0:9, :D].T, gathered), "prep: the rows differ from the twin's")
    check(bool((packed[0:3, D:] == FAR).all()) and not bool(packed[3:, D:].any()),
          "prep: the padding is not FAR positions and zeros")
    check(not bool(packed[9:].any()), "prep: rows 9-15 are not zero")
    return {"deposits": D, "valid": int(deps.valid.sum()), "padded": Dp}


def measure(d: int, res: int, photons: int, reps: int, device) -> dict:
    keys, cols = synthetic(d, device)
    outs, cands = {}, {}
    for name, fn in CANDIDATES.items():
        outs[name] = fn(keys, cols)
        dev_ms, wall_ms = call_times(lambda fn=fn: fn(keys, cols), reps, device)
        cands[name] = {"device_ms": dev_ms, "wall_ms": wall_ms}
    check_candidates(outs)
    del outs
    for name, why in NO_COUNTERPART.items():
        cands[name] = {"device_ms": None, "wall_ms": None, "no_counterpart": why}
    dep_fn, deps = bench_round(res, photons, device)
    prep = check_prep(dep_fn, deps)
    dev_ms, wall_ms = call_times(lambda: dep_fn._dep_sorted(deps, dep_fn.chunk), reps, device)
    cands["g_port_prep"] = {"device_ms": dev_ms, "wall_ms": wall_ms, **prep,
                            "source": "raytrace3_tpu_torch/ops/deposit_kernel.py "
                                      "DepositTile._dep_sorted"}
    return {"candidates": cands, "outputs_identical": True}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "DEPPREP_PORT.json"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    try:
        res = measure(args.d, args.res, args.photons, args.reps, device)
    except AssertionError as e:
        print(f"depprep: {e}", file=sys.stderr)
        return 1
    record = {"what": "the deposit's per-round sort and row permute "
                      "(scripts/perf_depprep_micro.py's candidates and the port's prep)",
              "d": args.d, "res": args.res, "photons": args.photons, "reps": args.reps,
              **res, "torch": torch.__version__, **record_fields(device),
              "reduced": [f"{k} {v} -> {getattr(args, k)}" for k, v in DEFAULTS.items()
                          if getattr(args, k) != v]}
    for name, r in record["candidates"].items():
        if r["wall_ms"] is None:
            print(f"{name:14s} no PyTorch counterpart")
            continue
        dev = "n/a" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        print(f"{name:14s} device {dev} ms, wall {r['wall_ms']:.3f} ms")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in ("d", "outputs_identical", "device", "card",
                                             "power_limit")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
