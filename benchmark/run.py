"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernels loaded or built, the
inputs made from the seed, one warm pass) is timed from the process's
start as ``setup_s``; the window then measures for ``--seconds`` seconds
(``--trace 0``: the cell's end-to-end metrics) or profiles the cell's
traced passes (``--trace 1``: its per-layer metrics).  After the window the
output is checked against the plain reference; each compared number and
its limit is printed last on standard error and under ``checks``, the last
key of the result, the last line of standard output.

Runs only on NVIDIA cards: without enough of them it exits with 2 and
prints no result.  It also refuses (exit 3, no result) if JAX or the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: The checkout's root.  The program builds its kernels once into its own
#: ``raytrace3_tpu_torch/_build/``, a fixed directory inside the checkout.
ROOT = Path(__file__).resolve().parent.parent
#: Top-level modules that must not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace3_tpu")


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from benchmark.harness import spec

    man = spec.manifest()
    entry = next((w for w in man["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    c = spec.cell(args.workload)
    w, config = c["workload"], c["config"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"the cell needs {entry['chips']} NVIDIA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    driver = importlib.import_module(f"benchmark.drivers.{config['driver']}")
    cell = driver.build(config, c["traffic"], device, args.seed, log)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    log(f"setup_s {setup_s:.3f}")

    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), w["limits"],
                     w["trace_passes"], log)
    found = forbidden_modules()
    if found:
        log(f"refused: {found} loaded in the process that reports")
        return 3

    if args.trace:
        metrics = {}
        for m in spec.per_layer(man, args.workload):
            value = spec.reader(m["name"])(out["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(man, args.workload)}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    correct = all(x["value"] <= x["limit"] for x in checks.values())
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                  "count": entry["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_rec}
    if args.trace:
        device_rec["busy_s"] = out["busy_s"]
        device_rec["window_s"] = out["traced_window_s"]
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for k, x in checks.items():
        print(f"check {k}: {x['value']!r} (limit {x['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
