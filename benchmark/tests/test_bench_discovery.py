"""A cell is added by adding files: the harness finds it by name."""

import json
import shutil

from benchmark.harness import spec


def test_a_dropped_in_workload_file_is_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = spec.manifest()
    man["workloads"].append({"name": "teapot512.onebig", "config": "teapot512",
                             "traffic": "passes1x2m", "chips": 1, "why": "one round"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (bench / "traffic" / "passes1x2m.json").write_text(json.dumps(
        {"pass": {"rounds": 1, "photons_per_round": 2097152}}))
    w = json.loads((bench / "workloads" / "teapot512.bigrounds.json").read_text())
    w.update(traffic="passes1x2m", why="one round")
    (bench / "workloads" / "teapot512.onebig.json").write_text(json.dumps(w))

    c = spec.cell("teapot512.onebig", bench)
    assert c["traffic"]["pass"]["rounds"] == 1
    assert c["config"]["name"] == "teapot512"
    man2 = spec.manifest(tmp_path)
    assert {m["name"] for m in spec.end_to_end(man2, "teapot512.onebig")} == {"setup_s"}
    # A per-layer metric added as a file is read by name too.
    (bench / "metrics" / "passes_traced.render.py").write_text(
        "def read(layer):\n    return layer.get('passes')\n")
    assert spec.reader("passes_traced.render", bench)({"passes": 3}) == 3
