#!/usr/bin/env python3
"""Each stage of the deposit alone, on the PyTorch/CUDA port, after
``scripts/perf_deposit_micro.py``.

    python3 scripts/torch_perf_deposit_micro.py [--d 1835008] [--c 340787]
        [--reps 8] [--seed 0] [--platform cpu] [--out docs/DEPOSIT_MICRO_PORT.json]

JAX's inputs at bench.py's teapot512 shapes: D = 14 x 131072 deposits a
round, compacted to Dc = 0.9 D, against C = 512^2 x 1.3 hit points;
positions uniform in [0, 100]^3, normals standard normal, flux uniform in
[0, 1], 80% of the deposits valid, every hit point valid with r2 = 2.  They
are drawn from one ``torch.Generator`` seeded ``--seed`` on the device, in
JAX's order (its five keys).  JAX leaves the hit points' normals and weights
0, so no pair passes the normal test and the deposit takes nothing; here the
normals are drawn after JAX's draws (standard normal) and the weights are 1,
so stage 4 tests and takes real pairs (``pairs_taken``).  The five stages,
each timed alone:

  1. ``compact_nonzero_gather``: ``render/photon.compact_deposits`` to Dc;
  2. ``argsort_keys``: the stable argsort of JAX's f32 keys
     (floor(x / 2.83) x 4096 + y);
  3. ``row_gather_transpose``: the rows gathered in that order and packed,
     transposed, into (16, Dc);
  4. ``block_deposit_full``: the whole ``DepositBlock`` call (tile 512,
     wchunk 1024, work cap 16384: JAX's ``PallasDeposit``, kernel #5 on the
     card) on the compacted round, with its layout prepared once;
  5. ``prepare_once_per_pass``: ``DepositBlock.prepare``, the hit-point
     layout.

Each in device ms (CUDA events; None on the CPU) and wall ms (the host's
clock to the work finished), medians of ``--reps`` calls after a warm one
(``core/device.call_times``); stage 5 at JAX's two.  The deposit's
``overflow`` (lanes its work cap left out), the pairs it took and the
kernels' launches are recorded beside it.  Writes the record with the device, the card's name
and power limit and ``reduced``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raytrace3_tpu_torch.core.device import (call_times, record_fields,  # noqa: E402
                                             resolve_device)

DEFAULTS = dict(d=14 * 131072, c=int(512 * 512 * 1.3), reps=8)
#: The compacted share of a round (``perf_deposit_micro.py:64``).
COMPACT_FRAC = 0.9
#: Stage 5's timed calls (JAX's ``n=2``).
PREPARE_REPS = 2


def inputs(d: int, c: int, seed: int, device):
    """(deposits (d,), hit points (c,)): JAX's script's draws, then the hit
    points' normals."""
    from raytrace3_tpu_torch.core.types import Deposits, make_hitpoints

    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    dep = Deposits(pos=u(d, 3) * 100.0, n=torch.randn((d, 3), generator=g, device=device),
                   flux=u(d, 3), valid=u(d) < 0.8)
    hp = make_hitpoints(c, 2.0, device)
    hp = hp.replace(pos=u(c, 3) * 100.0, valid=torch.ones((c,), dtype=torch.bool,
                                                          device=device))
    # JAX's normals 0 would fail every pair's normal test: drawn after
    # JAX's draws; weights 1 so the flux taken is not 0 either.
    return dep, hp.replace(n=torch.randn((c, 3), generator=g, device=device),
                           wgt=torch.ones((c, 3), dtype=torch.float32, device=device))


def sort_keys(dep):
    """JAX's f32 sort keys of stage 2."""
    kx = torch.floor(dep.pos[:, 0] / 2.83).to(torch.int32)
    return kx.to(torch.float32) * 4096.0 + dep.pos[:, 1]


def pack(dep, order):
    """Stage 3: the rows in ``order``, with 7 zero rows, as (16, Dc)."""
    n = order.shape[0]
    rows = torch.cat([dep.pos[order], dep.n[order], dep.flux[order],
                      torch.zeros((n, 7), dtype=torch.float32, device=order.device)], 1)
    out = torch.zeros((16, n), dtype=torch.float32, device=order.device)
    out[:, :] = rows.T
    return out


def measure(d: int, c: int, reps: int, seed: int, device) -> dict:
    from raytrace3_tpu_torch.ops.cuda_build import launch_counts, launches_since
    from raytrace3_tpu_torch.ops.deposit_kernel import DepositBlock
    from raytrace3_tpu_torch.render.photon import compact_deposits

    dc = int(d * COMPACT_FRAC)
    dep, hp = inputs(d, c, seed, device)
    stages = {}

    def stage(name, fn, n=reps):
        dev_ms, wall_ms = call_times(fn, n, device)
        stages[name] = {"device_ms": dev_ms, "wall_ms": wall_ms}
        dev = "n/a" if dev_ms is None else f"{dev_ms:.3f}"
        print(f"{name:24s} device {dev} ms, wall {wall_ms:.3f} ms", file=sys.stderr, flush=True)

    depc = compact_deposits(dep, dc)
    stage("compact_nonzero_gather", lambda: compact_deposits(dep, dc))
    keys = sort_keys(depc)
    stage("argsort_keys", lambda: torch.argsort(keys, stable=True))
    order = torch.argsort(keys, stable=True)
    stage("row_gather_transpose", lambda: pack(depc, order))
    depo = DepositBlock(tile=512, wchunk=1024, work_cap=16384)
    prep = depo.prepare(hp)
    before = launch_counts()
    cnt, _, overflow = depo(hp, depc, prep=prep)
    stage("block_deposit_full", lambda: depo(hp, depc, prep=prep))
    stages["block_deposit_full"].update(overflow=int(overflow), pairs_taken=int(cnt.sum()),
                                        launches=launches_since(before))
    stage("prepare_once_per_pass", lambda: depo.prepare(hp), n=PREPARE_REPS)
    return {"dc": dc, "valid": int(dep.valid.sum()), "stages": stages}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "DEPOSIT_MICRO_PORT.json"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    print(f"# D={args.d} C={args.c} device={device.type}", file=sys.stderr, flush=True)
    res = measure(args.d, args.c, args.reps, args.seed, device)
    record = {"what": "each stage of the deposit alone (scripts/perf_deposit_micro.py's "
                      "stages on the port)",
              "d": args.d, "c": args.c, "reps": args.reps, "seed": args.seed, **res,
              "deposit": "DepositBlock(tile=512, wchunk=1024, work_cap=16384), kernel #5",
              "torch": torch.__version__, **record_fields(device),
              "reduced": [f"{k} {v} -> {getattr(args, k)}" for k, v in DEFAULTS.items()
                          if getattr(args, k) != v]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in ("d", "dc", "c", "device", "card",
                                             "power_limit")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
