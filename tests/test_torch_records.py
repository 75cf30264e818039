"""The records the port's tooling wrote on the card, after
tests/test_torch_crossval.py's check of the crossval records.

Each ``docs/*_PORT.json`` of Slice E exists, was written on the card (its
``device`` is not the CPU, and it names the card and its power limit),
carries the keys of the JAX record it stands beside, and dropped nothing.
The grad check's record passes by the JAX script's own rule, recomputed
here from its checks; the albedo recovery ends below 1% of its initial
identifiable parameter error; the Epanechnikov ctrl recovery starts from
JAX's perturbation.  The tools' records carry their keys: the bisect every
variant (``rbg`` without a counterpart) with its full pass drop-free, the
deposit micro every stage (its block deposit taking pairs), the sweep every
one of JAX's configurations held to its plain twin and with its counts
equal to the reference row's wherever it did not overflow.
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
    "INVERSE_CTRL_EPA_PORT.json": ("docs/INVERSE_CTRL_EPA.json", "torch_inverse_render.py"),
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


def test_ctrl_epa_record_starts_where_jax_does():
    """The Epanechnikov ctrl recovery at JAX's record's settings draws JAX's
    perturbation: the same start, the same coordinates."""
    rec, jax_rec = _load("docs/INVERSE_CTRL_EPA_PORT.json"), _load("docs/INVERSE_CTRL_EPA.json")
    for k in ("res", "steps", "n_avg", "sigma", "lr", "photons_per_step", "deposit_kernel",
              "initial_param_err", "initial_surface_err", "identifiable_coords"):
        assert rec[k] == jax_rec[k], k
    assert rec["initial_param_err"] == 0.01413


#: The records of the host-side tools, the dry run and the four-card
#: readings, each with the keys its script writes at its defaults.
CARD_RECORDS = {
    "DISPATCH_PORT.json": {"item_scalar_s", "generators_x8_s", "pass_issue_s",
                           "drain_4_passes_s", "wall_per_pass_n2_s", "wall_per_pass_n4_s",
                           "wall_per_pass_n8_s", "wall_per_pass_n4_generators_inside_s",
                           "launches_per_pass", "host_us_per_launch", "syncs_per_pass",
                           "sync_lines"},
    "COMPACT_PORT.json": {"n", "cap", "frac", "d", "compaction", "key_sort",
                          "outputs_identical"},
    "DEPPREP_PORT.json": {"d", "candidates", "outputs_identical"},
    "MULTICHIP_PORT.json": {"mesh", "ranks", "backend", "loss", "forward", "train"},
    "SHARDED_CARDS_PORT.json": {"cards", "shapes", "supers"},
    "PERF_BISECT_PORT.json": {"res", "rounds", "photons", "timed_passes", "variants"},
    "DEPOSIT_MICRO_PORT.json": {"d", "dc", "c", "stages"},
    "DEPOSIT_SWEEP_PORT.json": {"d", "c", "rows", "counts_reference", "pairs_counted",
                                "all_rows_ok"},
}


@pytest.mark.parametrize("name", sorted(CARD_RECORDS))
def test_host_side_record_written_on_the_card(name):
    rec = _load(f"docs/{name}")
    assert rec["device"] == "cuda" and rec["card"] and rec["power_limit"].endswith("W")
    assert "reduced" in rec or name == "MULTICHIP_PORT.json"
    assert CARD_RECORDS[name] <= set(rec), sorted(CARD_RECORDS[name] - set(rec))
    if name == "DISPATCH_PORT.json":
        assert rec["launches_per_pass"] > 0 and rec["host_us_per_launch"] > 0
        assert rec["syncs_per_pass"] == sum(v["count"] for v in rec["sync_lines"].values())
        assert len(rec["pass_issue_s"]) == 4 and rec["reduced"] == []
    if name in ("COMPACT_PORT.json", "DEPPREP_PORT.json"):
        assert rec["outputs_identical"] and rec["reduced"] == []
    if name == "PERF_BISECT_PORT.json":
        bisect = load_script("torch_perf_bisect")
        assert list(rec["variants"]) == list(bisect.VARIANTS)
        assert set(rec["variants"]["rbg"]) == {"no_counterpart"}
        full = rec["variants"]["full"]
        assert full["dropped"] == full["deposits_dropped"] == 0
        assert full["launches"]["newton"] > 0 and full["launches"]["deposit_block"] > 0
        assert rec["res"] == 512 and rec["rounds"] == 16 and rec["photons"] == 131072
    if name == "DEPOSIT_MICRO_PORT.json":
        assert all(st["device_ms"] > 0 for st in rec["stages"].values())
        assert rec["reduced"] == [] and rec["d"] == 14 * 131072
        assert rec["stages"]["block_deposit_full"]["pairs_taken"] > 0
    if name == "DEPOSIT_SWEEP_PORT.json":
        sweep = load_script("torch_perf_deposit_sweep")
        assert [r["cfg"] for r in rec["rows"]] == [n for n, _, _ in sweep.configs()]
        assert rec["counts_reference"] == "tile1d_t128_ch1024" and rec["pairs_counted"] > 0
        for r in rec["rows"]:
            assert "error" not in r and r["device_ms"] > 0, r["cfg"]
            assert r["counts_equal_reference"] or r["overflow"] > 0, r["cfg"]
            assert r["holds_twin"] and r["twin_count_mismatch"] == 0, r["cfg"]
            assert r["twin_pairs"] > 0 and r["twin_flux_rel"] <= sweep.TWIN_FLUX_RTOL, r["cfg"]
        assert rec["all_rows_ok"] and rec["reduced"] == []


def test_multichip_record_is_the_2x4_dry_run():
    """``docs/MULTICHIP_PORT.json`` carries MULTICHIP_r05.json's keys and
    is the dry run on 8 ranks, a 2 x 4 mesh, every rank agreeing, both
    drop counters 0 in both steps."""
    rec = _load("docs/MULTICHIP_PORT.json")
    assert set(_load("MULTICHIP_r05.json")) <= set(rec)
    assert rec["mesh"] == {"pass": 2, "photon": 4} and rec["ranks"] == rec["n_devices"] == 8
    assert rec["ok"] and rec["rc"] == 0 and not rec["skipped"]
    assert "mesh={'pass': 2, 'photon': 4}" in rec["tail"]
    assert rec["forward"]["dropped"] == rec["forward"]["deposits_dropped"] == 0
    assert rec["train"] == {"deposits_dropped": 0, "dropped": 0}
