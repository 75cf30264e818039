"""The manifest and the files it names load and agree."""

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = spec.manifest()


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_files_agree_with_the_manifest(w):
    c = spec.cell(w["name"])
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert c["workload"]["config"] == w["config"]
    assert c["workload"]["traffic"] == w["traffic"]
    assert c["workload"]["chips"] == w["chips"] == 1
    assert c["workload"]["why"] == w["why"] and len(w["why"]) <= 200
    assert set(c["workload"]["limits"]) == {
        "image_replay_diff", "stage_faults", "walk_mismatch_share",
        "deposit_mismatch_share", "update_rel_err", "estimate_rel_err"}
    assert c["traffic"]["pass"]["rounds"] * c["traffic"]["pass"]["photons_per_round"] > 0
    names = {m["name"] for m in spec.end_to_end(MAN, w["name"])}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer(MAN, w["name"])


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((spec.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert c["file"].startswith("benchmark/configs/")


def test_metric_entries():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
