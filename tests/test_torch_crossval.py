"""Cross-validation of the PyTorch/CUDA port against the independent C++
implementation (native/baseline_sppm.cpp), after tests/test_crossval.py.

The full-size records (128^2, 2M photons, run on the card) are
docs/CROSSVAL_PORT{,_TEX,_SPPM,_PN8}.json, written by
scripts/torch_crossval.py.  The small end-to-end run builds the C++ binary
and renders both sides on the CPU; it takes minutes, so it is opt-in via
RT3_CROSSVAL=1.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The records and the run each comes from.
RECORDS = {"CROSSVAL_PORT.json": [], "CROSSVAL_PORT_TEX.json": ["--textures"],
           "CROSSVAL_PORT_SPPM.json": ["--update-mode", "sppm"],
           "CROSSVAL_PORT_PN8.json": ["--newton-restarts", "8"]}


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("RT3_CROSSVAL") != "1",
                    reason="set RT3_CROSSVAL=1 (builds+runs the C++ side; minutes)")
def test_port_crossval_full_scene_small(tmp_path):
    out = str(tmp_path / "crossval.json")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_crossval.py"),
         "--res", "64", "--photons", "262144", "--platform", "cpu", "--block", "8",
         "--out", out, "--png", str(tmp_path / "port.png")],
        capture_output=True, text=True, timeout=3600, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.load(open(out))
    assert rec["pass"], rec


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_port_crossval_artifacts_recorded(name):
    """The checked-in full-size verdicts exist and pass (regenerate on the
    card with ``scripts/torch_crossval.py`` and the record's flags)."""
    path = os.path.join(REPO, "docs", name)
    assert os.path.exists(path), f"{name} missing - run scripts/torch_crossval.py " + \
        " ".join(RECORDS[name])
    rec = json.load(open(path))
    assert rec["pass"], rec
    assert rec["rel_err_mean"] < 0.10, rec
    assert rec["psnr_tonemapped_db"] > 25.0, rec
    assert rec["blocks_compared"] >= 0.75 * rec["blocks_total"], rec
    assert rec["port_stats"]["deposits_dropped"] == 0 and rec["port_stats"]["dropped"] == 0
    assert rec["res"] == 128 and rec["photons_each"] == 2097152 and rec["block"] == 16
    assert rec["device"] != "cpu" and rec["card"], rec
