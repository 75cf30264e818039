#!/usr/bin/env python3
"""The reference's converged workload on the PyTorch/CUDA port, after
``scripts/reference1024.py``.

    python3 scripts/torch_reference1024.py [--passes 50] [--deposit tile]
        [--platform cpu] [--res R] [--profile-dir DIR] [--out PATH] [--png PATH]

Runs the ``reference1024`` preset (``full``, 1024^2, 8 x 131072 photons a
pass, depth 13, the regen walk, the Newton kernel #1) through the port's
CLI, ``cli.main``, with the deposit JAX's script chooses (``tile``: the tile
deposit, kernel #2), the progressive preview and checkpoints off, and
records the per-pass medians: s/pass, photons/s and Mrays/s (pass 1 carries
the kernels' first load), both drop totals over every pass, the final hit
points and mean r2.  ``--profile-dir`` passes the CLI's own flag on (a
``torch.profiler`` trace of the second pass) and adds the trace's kernel
launches, device busy time, idle share and top kernels to the record.
Writes ``docs/REFERENCE1024_PORT.json`` (JAX's keys, with the device, the
card's name and power limit, and ``reduced``), the PNG and the per-pass
metrics JSONL; a run that dropped an eye ray or a deposit writes no record
and exits 3 (``utils.metrics.refuse_drops``).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raytrace3_tpu_torch.core.device import record_fields, resolve_device  # noqa: E402
from raytrace3_tpu_torch.utils.metrics import DROP_COUNTERS, refuse_drops  # noqa: E402

PASSES = 50
RES = 1024


def trace_summary(path: str, top: int = 5) -> dict:
    """Kernel launches, device busy seconds, the pass's wall seconds on the
    trace's clock, the idle share and the ``top`` kernels by device time of
    a ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wall_us = (max(e["ts"] + e["dur"] for e in spans) - min(e["ts"] for e in spans))
    busy_us = sum(e["dur"] for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"trace": os.path.basename(path), "kernel_launches": len(kernels),
            "device_busy_s": busy_us / 1e6, "traced_wall_s": wall_us / 1e6,
            "device_idle_share": 1.0 - busy_us / max(wall_us, 1e-9),
            "top_kernels": [{"name": n[:120], "device_ms": v[0] / 1e3, "launches": v[1]}
                            for n, v in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=PASSES)
    ap.add_argument("--deposit", default="tile")
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--res", type=int, default=None, help="cut the canvas (a CPU check)")
    ap.add_argument("--rounds", type=int, default=None, help="cut the rounds (a CPU check)")
    ap.add_argument("--photons", type=int, default=None, help="cut photons a round")
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "REFERENCE1024_PORT.json"))
    ap.add_argument("--png", default=os.path.join(REPO, "docs", "reference1024_port.png"))
    ap.add_argument("--metrics", default=os.path.join(REPO, "docs",
                                                      "reference1024_port_metrics.jsonl"))
    args = ap.parse_args(argv)

    device = resolve_device(args.platform)
    from raytrace3_tpu_torch import cli

    if os.path.exists(args.metrics):
        os.remove(args.metrics)
    flags = ["--preset", "reference1024", "--passes", str(args.passes),
             "--deposit", args.deposit, "--out", args.png, "--metrics-jsonl", args.metrics,
             "--checkpoint-every", "0", "--preview-every", "0", "--platform", device.type]
    reduced = [] if args.passes == PASSES else [f"passes {PASSES} -> {args.passes}"]
    for flag, value, what in (("--res", args.res, f"canvas {RES}^2 -> {args.res}^2"),
                              ("--rounds", args.rounds, f"rounds 8 -> {args.rounds}"),
                              ("--photons", args.photons,
                               f"photons a round 131072 -> {args.photons}")):
        if value:
            flags += [flag, str(value)]
            reduced.append(what)
    if args.profile_dir:
        flags += ["--profile-dir", args.profile_dir]
    rc = cli.main(flags)
    if rc != 0:
        raise SystemExit(f"cli.main exited {rc}")

    recs = [json.loads(line) for line in open(args.metrics)]
    refuse_drops({k: sum(r[k] for r in recs) for k in DROP_COUNTERS},
                 f"reference1024 over {len(recs)} passes")
    ps = np.array([r["pass_seconds"] for r in recs])
    pps = np.array([r["photons_per_s"] for r in recs])
    emitted = pps * ps
    mrays = np.array([r.get("mrays_per_s", 0.0) for r in recs])
    record = {
        "preset": "reference1024 (the reference's converged workload: 1024^2, ~50M photons, "
                  "README.md:349-351)",
        "deposit": args.deposit,
        "passes": len(recs),
        "photons_per_pass": int(np.median(emitted)),
        "photons_total": int(emitted.sum()),
        "pass_seconds_median": float(np.median(ps)),
        "photons_per_s_in_pass_median": float(np.median(pps)),
        "mrays_per_s_median": float(np.median(mrays)),
        "pass_seconds": [float(x) for x in ps],
        "hitpoints_final": int(recs[-1].get("hitpoints", 0)),
        "deposits_dropped_total": int(sum(r["deposits_dropped"] for r in recs)),
        "eye_dropped_total": int(sum(r["dropped"] for r in recs)),
        "mean_r2_final": float(recs[-1].get("mean_r2", 0.0)),
        "image": os.path.relpath(args.png, REPO),
        "backend": device.type, **record_fields(device), "reduced": reduced,
    }
    if args.profile_dir:
        record["profile"] = trace_summary(os.path.join(args.profile_dir, "pass1.trace.json"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
