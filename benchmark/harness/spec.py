"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, and under ``benchmark/`` the cell's ``workloads/<cell>.json``, its
``configs/<config>.json``, its ``traffic/<traffic>.json`` and each per-layer
metric's reader ``metrics/<metric>.py``.  Adding a cell, a configuration, a
traffic mix or a metric is adding files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, bench: Path = BENCH) -> dict:
    """{"workload", "config", "traffic"} of the cell ``name``."""
    w = _json(bench / "workloads" / f"{name}.json")
    return {"workload": w, "config": _json(bench / "configs" / f"{w['config']}.json"),
            "traffic": _json(bench / "traffic" / f"{w['traffic']}.json")}


def applies(metric: dict, name: str, e2e_names: set) -> bool:
    """Whether ``metric`` of the manifest is reported in cell ``name``."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric["moves"] in e2e_names


def end_to_end(man: dict, name: str) -> list:
    return [m for m in man["end_to_end"] if "workloads" not in m or name in m["workloads"]]


def per_layer(man: dict, name: str) -> list:
    e2e = {m["name"] for m in end_to_end(man, name)}
    return [m for m in man["per_layer"] if applies(m, name, e2e)]


def reader(metric: str, bench: Path = BENCH):
    """The ``read(layer) -> float | None`` of ``metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
