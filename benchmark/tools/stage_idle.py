"""Which stage of the pass leaves the card idle: the idle share of a cell's
traced window split by the program's ``rt3.*`` spans, with the Bezier
compaction's tally, in one process.

    python3 benchmark/tools/stage_idle.py --workload teapot512.render --seed0 7000000000 --runs 3

Builds the cell once, then for each of ``--runs`` seeds profiles the cell's
traced passes as a ``--trace 1`` run of ``benchmark/run.py`` does (each pass
inside a ``bench.pass`` span) and prints one JSON line: the idle share of
the window, the shares of it inside the walk (``rt3.walk``), the eye
(``rt3.eye``) and the fold (``rt3.prepare``, ``rt3.fold``, ``rt3.estimate``)
from ``harness/spans.py``, launch calls a pass, and the compaction's
overflow a pass and lane use, summed from the traced passes' own stats
after the profiler stops.  A number whose spans or counters the program
lacks is left out.  Runs on the card; the benchmark's result line does not
carry these numbers.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: Each stage's share and the span names whose idle seconds it sums (the
#: spans never nest, so the sums do not overlap).
STAGES = {"walk_idle_share": ("rt3.walk",), "eye_idle_share": ("rt3.eye",),
          "fold_idle_share": ("rt3.prepare", "rt3.fold", "rt3.estimate")}
#: The program's Bezier compaction counters in a pass's stats.
COUNTERS = ("bezier_overflow", "bezier_lanes_used", "bezier_lanes")


def traced(cell, seed: int, passes: int):
    """Passes 0..passes-1 of ``seed`` under the benchmark's profiler, as a
    traced run takes them: (the trace's records, each pass's stats)."""
    from torch.profiler import record_function

    from benchmark.harness import profile

    kept = []
    real = cell.pass_fn

    def keep(rng):
        img, stats = real(rng)
        kept.append(stats)
        return img, stats

    cell.pass_fn = keep
    try:
        prof = profile.Trace()
        accum = cell.zeros()
        with prof:
            for i in range(passes):
                with record_function(profile.PASS_SPAN):
                    _, _, accum, _ = cell.one_pass(seed, i, accum)
    finally:
        cell.pass_fn = real
    return prof.records(), kept


def numbers(records: list, stats: list) -> dict:
    """The traced window's idle share and its split by stage (in % of the
    window), launch calls a pass, and the compaction's overflow a pass and
    lane use (%), from the records and the passes' stats."""
    from benchmark.harness import profile, spans

    s = profile.summarize(records)
    window = s["window_s"]
    out = {"idle_share": 100.0 * (1.0 - s["busy_s"] / window),
           "launch_calls_per_pass": s["runtime_calls"] / s["passes"]}
    idle = spans.idle_in_spans(records)
    for name, span_names in STAGES.items():
        if all(n in idle for n in span_names):
            out[name] = 100.0 * sum(idle[n] for n in span_names) / window
    if stats and all(k in st for st in stats for k in COUNTERS):
        tally = {k: sum(int(st[k]) for st in stats) for k in COUNTERS}
        out["bezier_overflow_per_pass"] = tally["bezier_overflow"] / len(stats)
        if tally["bezier_lanes"]:
            out["bezier_lane_use"] = 100.0 * tally["bezier_lanes_used"] / tally["bezier_lanes"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.drivers import render
    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("stage_idle: no card", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    cell = render.build(c["config"], c["traffic"], torch.device("cuda", 0), args.seed0,
                        lambda m: print(m, file=sys.stderr))
    for k in range(args.runs):
        seed = args.seed0 + k
        records, stats = traced(cell, seed, c["workload"]["trace_passes"])
        rec = {"workload": args.workload, "seed": seed, "passes": len(stats),
               **numbers(records, stats)}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
