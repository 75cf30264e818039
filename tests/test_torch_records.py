"""The records the port's tooling wrote on the card, after
tests/test_torch_crossval.py's check of the crossval records.

Each ``docs/*_PORT.json`` of Slice E exists, was written on the card (its
``device`` is not the CPU, and it names the card and its power limit),
carries the keys of the JAX record it stands beside, and dropped nothing.
The grad check's record passes by the JAX script's own rule, recomputed
here from its checks; the albedo recovery ends below 1% of its initial
identifiable parameter error.
"""

import json
import os

import pytest

from raytrace3_tpu_torch.testing import load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Each record of the port's tooling, the JAX record beside it (a path
#: from the repository root) and the script that writes it.
RECORDS = {
    "NEWTON_RESTARTS_PORT.json": ("docs/NEWTON_RESTARTS.json", "torch_newton_restart_study.py"),
    "GRADCHECK_PORT.json": ("GRADCHECK.json", "torch_gradcheck.py"),
    "INVERSE_ALBEDO_PORT.json": ("docs/INVERSE_ALBEDO.json", "torch_inverse_render.py"),
    "INVERSE_CTRL_PORT.json": ("docs/INVERSE_CTRL_RUN.json", "torch_inverse_render.py"),
    "INVERSE_CTRL_ANNEAL_PORT.json": ("docs/INVERSE_CTRL_ANNEAL.json",
                                      "torch_inverse_ctrl_anneal.py"),
    "REFERENCE1024_PORT.json": ("docs/REFERENCE1024.json", "torch_reference1024.py"),
    "TRAINSTEP_PORT.json": ("docs/TRAINSTEP.json", "torch_perf_trainstep.py"),
}
#: Keys of a JAX record that no script writes (the anneal record's note on
#: how it was reconstructed).
NOT_WRITTEN = {"note"}


def _load(rel):
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_record_written_on_the_card(name):
    jax_rel, script = RECORDS[name]
    assert os.path.exists(os.path.join(REPO, "scripts", script))
    rec = _load(f"docs/{name}")
    assert rec["device"] != "cpu" and rec["card"] and rec["power_limit"], rec.get("device")
    assert rec["power_limit"].endswith("W") and "reduced" in rec
    missing = set(_load(jax_rel)) - NOT_WRITTEN - set(rec)
    assert not missing, sorted(missing)
    drops = {k: v for k, v in rec.items() if "dropped" in k}
    if name != "NEWTON_RESTARTS_PORT.json":           # the study renders nothing
        assert set(drops) == {"eye_dropped_total", "deposits_dropped_total"}, drops
    assert all(v == 0 for v in drops.values()), drops


def test_gradcheck_record_passes_by_the_jax_rule():
    gc = load_script("torch_gradcheck")
    rec = _load("docs/GRADCHECK_PORT.json")
    assert set(rec["groups"]) == {f"{g}[{c}]" for g in gc.MIN_CHECKED for c in gc.COLUMNS}
    groups = {}
    for key, g in rec["groups"].items():
        checks = [{k: v for k, v in c.items() if k != "vacuous"} for c in g["checks"]]
        groups[key] = gc.summarize(key.split("[")[0], checks)
        assert groups[key] == g, key
    v = gc.verdict(groups)
    assert v == {k: rec[k] for k in v}
    assert rec["pass"] and rec["grad_check_pass_rate"] >= 0.9


def test_albedo_record_recovers_the_parameters():
    rec = _load("docs/INVERSE_ALBEDO_PORT.json")
    assert rec["steps"] == 300 and rec["res"] == 128
    assert rec["final_param_err_identifiable"] < 0.01 * rec["initial_param_err_identifiable"]
    assert rec["initial_param_err"] == _load("docs/INVERSE_ALBEDO.json")["initial_param_err"]
