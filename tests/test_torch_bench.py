"""The port's bench (``bench_torch.py``) on the CPU at a small size: its
last line is ``bench.py``'s record with ``card`` added, both drop
counters are zero, and the run imports no JAX."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The keys of bench.py's record (bench.py:218-235).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "pallas_newton",
              "newton_restarts", "mrays_per_s", "pass_seconds", "compile_seconds",
              "photons_per_pass", "deposits_dropped", "eye_dropped", "hitpoints",
              "cpp_baseline_photons_per_s", "cpp_threads"}

#: Runs the bench as a script, then reports on stderr whether JAX was
#: imported.
RUNNER = """
import runpy, sys
try:
    runpy.run_path(sys.argv[1], run_name="__main__")
finally:
    jax = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "raytrace3_tpu.")))
    print("IMPORTED " + ",".join(jax), file=sys.stderr)
"""


def test_bench_torch_line_on_cpu():
    env = dict(os.environ, RT3_BENCH_PLATFORM="cpu", RT3_BENCH_RES="32",
               RT3_BENCH_ROUNDS="2", RT3_BENCH_PHOTONS="1024", RT3_BENCH_TIMED="1",
               RT3_BENCH_BASELINE="0", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", RUNNER, os.path.join(REPO, "bench_torch.py")],
                       capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(rec) == BENCH_KEYS | {"card"}, sorted(rec)
    assert rec["backend"] == "cpu" and rec["card"] is None and rec["vs_baseline"] is None
    assert rec["pallas_newton"] is True and rec["newton_restarts"] == 8
    assert rec["deposits_dropped"] == 0 and rec["eye_dropped"] == 0
    assert rec["hitpoints"] > 900 and rec["value"] > 0 and rec["photons_per_pass"] > 2048
    imported = [ln for ln in r.stderr.splitlines() if ln.startswith("IMPORTED")]
    assert imported == ["IMPORTED "], imported

