"""The readings that a cell's check limits are set from, at the cell's own
size, in one process: pass 0 of each of ``--seeds`` seeds run and held to
the reference (the program's readings), and the same passes held with the
reference computed in TF32 in the program's place (the control's
readings), for the first ``--control`` seeds.

    python3 benchmark/tools/readings.py --workload teapot512.render --seed0 7000000000 --seeds 12 --control 3

Prints one JSON line per held pass.  Runs on the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.drivers import render
    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("readings: no card", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    cell = render.build(c["config"], c["traffic"], torch.device("cuda", 0), args.seed0,
                        lambda m: print(m, file=sys.stderr))
    for k in range(args.seeds):
        seed = args.seed0 + k
        img, host, _, dt = cell.one_pass(seed, 0, cell.zeros())
        subjects = ["program"] + (["control"] if k < args.control else [])
        for subject in subjects:
            t = time.perf_counter()
            h = cell.hold(seed, 0, img if subject == "program" else None, subject)
            rec = {"workload": args.workload, "seed": seed, "subject": subject,
                   "pass_s": dt, "check_s": time.perf_counter() - t, "drops": [
                       host["dropped"], host["deposits_dropped"]],
                   "faults": h.faults[:5], **render.numbers([h])}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
