"""On the card: one short run of each cell prints a correct result line
(run by hand on a machine with a card; skipped here)."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.manifest()["workloads"]])
def test_a_short_run_is_correct(card, name):
    out = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload", name,
                          "--seed", "2200000001", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
