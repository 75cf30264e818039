#!/usr/bin/env python3
"""Masked index compaction and the deposit-key sort on the card, after
``scripts/perf_compact_micro.py``.

    python3 scripts/torch_perf_compact_micro.py [--n 131072] [--cap 6553]
        [--d 1835008] [--reps 30] [--platform cpu]
        [--out docs/COMPACT_PORT.json]

Three ways to take the first ``cap`` True lanes of a mask of ``n`` lanes
(FRAC = 5% of them True, drawn from ``default_rng(0)``), padded with ``n``:

  * ``nonzero``: ``torch.nonzero`` padded to the cap; its output size
    depends on the data, so the host waits for the card (counted);
  * ``argsort``: the port's own ``ops/compact.compact_indices`` (a stable
    sort of ``~mask`` and a gather of the mask to re-validate);
  * ``sortkv``: ``torch.sort`` of the same key with its indices, validated
    from the sorted keys (JAX's ``lax.sort_key_val``: no gather).

Then the deposit-key pair at ``d`` float32 keys (``default_rng(1)``):
argsort and a gather of the keys against ``torch.sort``'s values and
indices, both stable.  Each candidate is timed in device ms (CUDA events
around a call) and wall ms (the host's clock to the call's end), medians
of ``reps`` calls, with the synchronising calls it makes counted.  Every
candidate's output must equal the others' (the script exits 1 if not).
Writes the record (``device``, ``card``, ``power_limit``, ``reduced``) to
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
                                             resolve_device, synchronizing_calls)

DEFAULTS = dict(n=131072, cap=6553, d=1835008)
FRAC = 0.05


def nonzero(m, cap):
    idx = torch.nonzero(m)[:cap, 0]
    out = torch.full((cap,), m.shape[0], dtype=torch.int64, device=m.device)
    out[:idx.shape[0]] = idx
    return out


def argsort(m, cap):
    from raytrace3_tpu_torch.ops.compact import compact_indices

    return compact_indices(m, cap)


def sortkv(m, cap):
    keys, idx = torch.sort((~m).to(torch.int32), stable=True)
    return torch.where(keys[:cap] == 0, idx[:cap], m.shape[0])


def argsort_gather(k):
    o = torch.argsort(k, stable=True)
    return k[o], o


def sort_pair(k):
    return torch.sort(k, stable=True)


COMPACTION = {"nonzero": nonzero, "argsort": argsort, "sortkv": sortkv}
KEY_SORT = {"argsort_gather": argsort_gather, "sort_key_val": sort_pair}


def check(ok: bool, what: str) -> None:
    """Raise ``AssertionError(what)`` unless ``ok`` (kept under -O)."""
    if not ok:
        raise AssertionError(what)


def inputs(n: int, d: int, device, frac: float = FRAC):
    """(mask, deposit keys): the mask of ``n`` lanes from
    ``default_rng(0)``, the ``d`` keys from ``default_rng(1)``."""
    mask = np.random.default_rng(0).random(n) < frac
    keys = np.random.default_rng(1).random(d).astype(np.float32)
    return torch.as_tensor(mask, device=device), torch.as_tensor(keys, device=device)


def measure(n: int, cap: int, d: int, reps: int, device) -> dict:
    """The record of every candidate on this run's inputs; raises
    ``AssertionError`` when two candidates' outputs differ."""
    mask, keys = inputs(n, d, device)
    out = {"compaction": {}, "key_sort": {}}
    got = {}
    for group, cands, arg in (("compaction", COMPACTION, None), ("key_sort", KEY_SORT, keys)):
        for name, fn in cands.items():
            call = (lambda fn=fn: fn(mask, cap)) if arg is None else (lambda fn=fn: fn(arg))
            res, syncs = synchronizing_calls(call, REPO)
            got[name] = res
            dev_ms, wall_ms = call_times(call, reps, device)
            out[group][name] = {"device_ms": dev_ms, "wall_ms": wall_ms,
                                "syncs": None if syncs is None else
                                sum(v["count"] for v in syncs.values()),
                                "sync_lines": syncs}
    ref = got["nonzero"].cpu()
    for name in ("argsort", "sortkv"):
        check(torch.equal(got[name].cpu(), ref), f"compaction {name} differs from nonzero")
    want = np.flatnonzero(mask.cpu().numpy())[:cap]
    check(np.array_equal(ref[:want.size].numpy(), want) and bool((ref[want.size:] == n).all()),
          "compaction nonzero differs from numpy's flatnonzero")
    a, b = got["argsort_gather"], got["sort_key_val"]
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), "the key sorts differ")
    out["valid_lanes"] = int(mask.sum())
    out["outputs_identical"] = True
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "COMPACT_PORT.json"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    try:
        res = measure(args.n, args.cap, args.d, args.reps, device)
    except AssertionError as e:
        print(f"compaction: {e}", file=sys.stderr)
        return 1
    record = {"what": "masked index compaction and the deposit-key sort "
                      "(scripts/perf_compact_micro.py's candidates)",
              "n": args.n, "cap": args.cap, "frac": FRAC, "d": args.d, "reps": args.reps,
              **res, "torch": torch.__version__, **record_fields(device),
              "reduced": [f"{k} {v} -> {getattr(args, k)}" for k, v in DEFAULTS.items()
                          if getattr(args, k) != v]}
    for group in ("compaction", "key_sort"):
        for name, r in record[group].items():
            dev = "n/a" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
            print(f"{group:10s} {name:15s} device {dev} ms, wall {r['wall_ms']:.4f} ms, "
                  f"syncs {r['syncs']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in ("n", "cap", "d", "outputs_identical", "device",
                                             "card", "power_limit")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
