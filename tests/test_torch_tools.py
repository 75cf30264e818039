"""The port's tooling scripts (``scripts/torch_*.py`` of Slice E) against
the JAX scripts they follow, on the CPU, on the same numpy-seeded inputs.

* The restart study's counts per population (miss, root_diff, false_hit)
  at 256 rays a population, the port's plain Newton twin against JAX's
  ``make_newton_pallas(interpret=True)``: equal.
* The grad check's coordinate picking, three-eps stability test, Wilson
  bound and verdicts on the same gradient and finite-difference inputs:
  equal (JAX's verdicts from its own ``main``).
* The port's cosine-decayed Adam against ``optax.adam`` under
  ``optax.cosine_decay_schedule`` over 20 steps of the same gradients:
  within 1e-6.
* Each script on the CPU at a small size writes a record whose keys
  include the JAX record's, with no drop, and imports no JAX.
* The three micro-benchmarks of the host side (``torch_perf_dispatch_
  micro``, ``torch_perf_compact_micro``, ``torch_perf_depprep_micro``):
  the compaction candidates equal each other and JAX's ``jnp.nonzero(mask,
  size=cap, fill_value=N)`` on the same mask, the key sorts and the row
  gathers equal numpy's stable argsort and gather, the port's deposit prep
  equals its row-gather twin, and each writes its keys.
"""

import copy
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from raytrace3_tpu_torch.testing import load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


study = load_script("torch_newton_restart_study")
gc = load_script("torch_gradcheck")
compact = load_script("torch_perf_compact_micro")
depprep = load_script("torch_perf_depprep_micro")

#: The fields of scripts/perf_dispatch_micro.py's record and their port
#: counterparts at ``--issue 4 --ns 2,4,8`` (JAX's), and the card's three.
DISPATCH_KEYS = {"item_scalar_s", "generators_x8_s", "pass_issue_s", "drain_4_passes_s",
                 "wall_per_pass_n2_s", "wall_per_pass_n4_s", "wall_per_pass_n8_s",
                 "wall_per_pass_n4_generators_inside_s", "launches_per_pass",
                 "host_us_per_launch", "syncs_per_pass", "sync_lines"}
#: Every record's keys about where it ran (``core.device.record_fields``).
WHERE = {"device", "card", "power_limit", "reduced", "torch"}

#: Runs a script as ``__main__``, then reports on stderr whether JAX was
#: imported (tests/test_torch_bench.py's runner).
RUNNER = """
import runpy, sys
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    jax = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "raytrace3_tpu.")))
    print("IMPORTED " + ",".join(jax), file=sys.stderr)
"""


def _run(script, *args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", RUNNER, os.path.join(REPO, "scripts", script),
                        *args], capture_output=True, text=True, timeout=timeout, cwd=REPO,
                       env=env)
    imported = [ln for ln in r.stderr.splitlines() if ln.startswith("IMPORTED")]
    return r, imported


def _jax_keys(name):
    with open(os.path.join(REPO, "docs", name)) as f:
        return set(json.load(f))


def test_restart_study_counts_match_jax():
    """At 256 rays a population (the eye population at 16^2) the port's
    counts at 4, 8, 16 and 32 restarts against its 64-restart oracle equal
    those of JAX's Pallas kernel in interpret mode on the same rays.  Both
    solve only the rays that open some patch box: the others accept no
    root by the solve's own gate and read a miss on both sides."""
    import jax
    import jax.numpy as jnp
    from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
    from raytrace3_tpu_torch.ops.newton_kernel import BIG, open_pairs

    ctrl = study.study_ctrl("cpu")
    pops = study.populations(ctrl, 256, 16)
    assert {k: v[0].shape[0] for k, v in pops.items()} == {"eye": 256, "photon": 256,
                                                            "grazing": 256}
    org = np.concatenate([o for o, _ in pops.values()])
    dir = np.concatenate([d for _, d in pops.values()])
    ends = np.cumsum([0] + [o.shape[0] for o, _ in pops.values()])
    rows = open_pairs(torch.as_tensor(org), torch.as_tensor(dir), ctrl).any(1).numpy()
    assert 0 < rows.sum() < len(rows)
    restarts = (*study.CANDIDATES, study.ORACLE)
    args = (jnp.asarray(org[rows]), jnp.asarray(dir[rows]), jnp.asarray(ctrl.numpy()))
    lowered = {r: jax.jit(make_newton_pallas(iters=study.ITERS, restarts=r, interpret=True))
               .lower(*args) for r in restarts}
    # XLA compiles JAX's five solvers in threads while the port's twin runs.
    with ThreadPoolExecutor(len(restarts)) as pool:
        compiled = {r: pool.submit(low.compile) for r, low in lowered.items()}
        port = {r: study.solve_rays(org, dir, ctrl, r, chunk=256) for r in restarts}
        ref = {}
        for r in restarts:
            t, _, _, _, hit = compiled[r].result()(*args)
            ref[r] = (np.full(len(rows), BIG, np.float32), np.zeros(len(rows), bool))
            ref[r][0][rows], ref[r][1][rows] = np.asarray(t), np.asarray(hit)
    for i, name in enumerate(pops):
        sl = slice(ends[i], ends[i + 1])
        cut = lambda out: (out[0][sl], out[1][sl])
        got = {r: study.score(*cut(port[study.ORACLE]), *cut(port[r])) for r in study.CANDIDATES}
        want = {r: study.score(*cut(ref[study.ORACLE]), *cut(ref[r])) for r in study.CANDIDATES}
        print(name, "oracle hits", int(port[study.ORACLE][1][sl].sum()), got)
        assert int(port[study.ORACLE][1][sl].sum()) == int(ref[study.ORACLE][1][sl].sum()) > 0
        for r in study.CANDIDATES:
            assert {k: got[r][k] for k in ("miss", "root_diff", "false_hit")} == \
                   {k: want[r][k] for k in ("miss", "root_diff", "false_hit")}, (name, r)


def _fake_loss(a, jumps, step):
    """A loss of a float32 array: linear with coefficients ``a`` plus jumps
    of ``jumps`` where a coordinate crosses a multiple of ``step``."""
    def loss(x):
        x = np.asarray(x, np.float64)
        return float(np.sum(a * x) + np.sum(jumps * np.floor(x / step)))
    return loss


def _fd_inputs(seed=3):
    """Arrays for one group's check: values, coefficients, jumps placed so
    that some coordinates' windows cross a multiple of ``step`` at eps/2,
    eps or 2 eps and others do not, and an autograd gradient that agrees,
    disagrees or lies under the signal floor."""
    rng = np.random.default_rng(seed)
    shape = (4, 4, 3)
    eps, step = 2.0 ** -11, 2.0 ** -4
    a = rng.uniform(-60, 60, shape)
    a.flat[:6] = rng.uniform(-5, 5, 6)                 # under the floor 3 * 0.003 / (2 eps)
    x = (rng.integers(1, 200, shape) * step + rng.uniform(0.1, 0.9, shape) * step)
    near = rng.choice(np.arange(6, 48), 12, replace=False)
    x.flat[near] = (np.rint(x.flat[near] / step) * step
                    + rng.choice([0.3, 0.7, 1.5, -0.3, -0.7, -1.5], 12) * eps)
    jumps = np.where(rng.uniform(size=shape) < 0.5, 0.02, 0.0)
    grad = a * np.where(rng.uniform(size=shape) < 0.2, rng.uniform(1.6, 2.5, shape), 1.0)
    return x.astype(np.float32), a, jumps, step, eps, grad.astype(np.float32)


def test_gradcheck_picking_and_stability_test_match_jax():
    import jax.numpy as jnp

    jgc = load_script("gradcheck")
    x, a, jumps, step, eps, grad = _fd_inputs()
    loss = _fake_loss(a, jumps, step)
    for n_top, n_rand in ((40, 16), (8, 4), (5, 2)):
        got = gc.pick_coords(grad, n_top, n_rand, np.random.default_rng(5))
        want = jgc.pick_coords(grad, n_top, n_rand, np.random.default_rng(5))
        assert [tuple(map(int, i)) for i in got] == [tuple(map(int, i)) for i in want]
    coords = gc.pick_coords(grad, 40, 8, np.random.default_rng(0))
    for name in ("ctrl", "atlas"):
        got = gc.check_group(lambda p: loss(p[name].numpy()), {name: torch.as_tensor(x)}, name,
                             coords, eps, {name: grad})
        want = jgc.check_group(lambda p: loss(np.asarray(p[name])), {name: jnp.asarray(x)},
                               name, coords, eps, {name: jnp.asarray(grad)})
        kinds = {k: sum(bool(r.get(k)) for r in got) for k in ("discont", "low_signal")}
        verdicts = [r["pass"] for r in got if "pass" in r]
        print(name, kinds, "pass", sum(verdicts), "of", len(verdicts))
        assert kinds["discont"] > 0 and kinds["low_signal"] > 0
        assert 0 < sum(verdicts) < len(verdicts)
        assert got == want


def test_gradcheck_wilson_bound_matches_jax():
    jgc = load_script("gradcheck")
    for n in range(0, 60):
        for p in range(0, n + 1):
            assert gc.wilson_lo(p, n) == jgc._wilson_lo(p, n), (p, n)


def test_gradcheck_verdicts_match_jax(tmp_path, monkeypatch):
    """Groups that pass, fail on their rate, lack scored coordinates, or
    are vacuous (all zero) get JAX's verdicts, by JAX's own ``main``."""
    jgc = load_script("gradcheck")
    ok = lambda i, p: {"coord": [i], "fd": 1.0 + i, "ad": 1.0 + i, "pass": p}
    groups = {
        "ctrl": [ok(i, i % 5 != 0) for i in range(10)] + [{"coord": [99], "fd": 0.1,
                                                             "ad": 0.2, "discont": True}],
        "atlas": [ok(i, True) for i in range(9)] + [{"coord": [50], "fd": 1e-4, "ad": 1e-4,
                                                       "low_signal": True}],
        "diff": [{"coord": [i], "fd": 0.0, "ad": 0.0, "pass": True} for i in range(9)],
    }
    out = tmp_path / "jax.json"
    monkeypatch.setattr(jgc, "run", lambda *a, **k: copy.deepcopy(groups))
    monkeypatch.setattr(sys, "argv", ["gradcheck.py", "--backends", "jnp", "--out", str(out)])
    assert jgc.main() == 1
    want = json.load(open(out))
    got = {f"{k}[jnp]": gc.summarize(k, copy.deepcopy(v)) for k, v in groups.items()}
    assert got == want["groups"]
    v = gc.verdict(got)
    assert v == {k: want[k] for k in ("checked", "passed", "grad_check_pass_rate", "pass")}
    assert [g["group_pass"] for g in got.values()] == [True, False, False]


def test_adam_cosine_matches_optax():
    """``diff.train.adam_cosine`` against ``optax.adam(optax.
    cosine_decay_schedule(lr, steps, alpha))`` over 20 steps of the same
    float32 gradients, from the same float32 start.  Optax computes the
    schedule and the bias corrections 1 - b^t in JAX's default float type;
    torch's Adam and scheduler in Python's double.  In 32 bits 1 - 0.999^t
    keeps only a few digits at small t, which alone moves optax's
    trajectory by ~1e-6, so optax runs with 64-bit types enabled (the
    parameters and gradients stay float32)."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytrace3_tpu_torch.diff.train import adam_cosine

    rng = np.random.default_rng(11)
    p0 = rng.uniform(0, 1, (8, 3)).astype(np.float32)
    grads = [rng.normal(0, 1, p0.shape).astype(np.float32) for _ in range(20)]
    for lr, alpha in ((2e-2, 0.02), (2e-3, 0.05)):
        t = torch.tensor(p0, requires_grad=True)
        topt, sched = adam_cosine([t], lr, 20, alpha)
        with jax.enable_x64(True):
            opt = optax.adam(optax.cosine_decay_schedule(lr, 20, alpha=alpha))
            p = jnp.asarray(p0)
            st = opt.init(p)
            for g in grads:
                upd, st = opt.update(jnp.asarray(g), st, p)
                p = optax.apply_updates(p, upd)
                t.grad = torch.as_tensor(g)
                topt.step()
                sched.step()
            assert p.dtype == jnp.float32
        err = np.abs(t.detach().numpy() - np.asarray(p)).max()
        print(f"lr {lr} alpha {alpha}: max |port - optax| {err:.3g}, moved "
              f"{np.abs(np.asarray(p) - p0).max():.3g}")
        assert err <= 1e-6


def test_reference1024_script_on_cpu(tmp_path):
    out = tmp_path / "ref.json"
    r, imported = _run("torch_reference1024.py", "--platform", "cpu", "--passes", "2",
                       "--res", "32", "--rounds", "1", "--photons", "1024", "--out", str(out),
                       "--png", str(tmp_path / "ref.png"), "--metrics", str(tmp_path / "m.jsonl"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.load(open(out))
    assert _jax_keys("REFERENCE1024.json") <= set(rec), sorted(rec)
    assert rec["passes"] == 2 and rec["device"] == "cpu" and rec["card"] is None
    assert rec["deposits_dropped_total"] == 0 and rec["eye_dropped_total"] == 0
    assert rec["hitpoints_final"] > 0 and rec["reduced"]
    assert imported == ["IMPORTED "], imported


def test_perf_trainstep_script_on_cpu(tmp_path):
    out = tmp_path / "train.json"
    r, imported = _run("torch_perf_trainstep.py", "--platform", "cpu", "--res", "16",
                       "--steps", "1", "--rounds", "1", "--photons", "256", "--out", str(out))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.load(open(out))
    assert _jax_keys("TRAINSTEP.json") <= set(rec), sorted(rec)
    assert rec["loss_finite"] and rec["steps_timed"] == 1 and rec["device"] == "cpu"
    assert rec["deposits_dropped_total"] == 0 and rec["eye_dropped_total"] == 0
    assert imported == ["IMPORTED "], imported


@pytest.mark.parametrize("exp,args,jax_record", [
    ("albedo", ["--res", "16", "--photons", "2048", "--steps", "3"], "INVERSE_ALBEDO.json"),
    ("ctrl", ["--res", "8", "--photons", "256", "--steps", "2", "--n-avg", "2"],
     "INVERSE_CTRL_RUN.json"),
])
def test_inverse_render_script_on_cpu(tmp_path, exp, args, jax_record):
    out = tmp_path / "inv.json"
    r, imported = _run("torch_inverse_render.py", "--platform", "cpu", "--exp", exp, *args,
                       "--out", str(out), "--png", str(tmp_path / "inv.png"))
    assert r.returncode in (0, 1), r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.load(open(out))
    assert _jax_keys(jax_record) <= set(rec), sorted(_jax_keys(jax_record) - set(rec))
    assert rec["deposits_dropped_total"] == 0 and rec["eye_dropped_total"] == 0
    assert np.isfinite(rec["final_loss"]) and rec["reduced"]
    if exp == "albedo":
        # JAX's draws: its record starts from the same parameter error
        assert rec["initial_param_err"] == 0.16566
    assert imported == ["IMPORTED "], imported


def test_inverse_ctrl_anneal_script_on_cpu(tmp_path):
    out = tmp_path / "anneal.json"
    r, imported = _run("torch_inverse_ctrl_anneal.py", "--platform", "cpu", "--res", "8",
                       "--photons", "1024", "--stages", "32,2", "--steps-per-stage", "2",
                       "--out", str(out),
                       "--png", str(tmp_path / "anneal.png"))
    assert r.returncode in (0, 1), r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.load(open(out))
    want = _jax_keys("INVERSE_CTRL_ANNEAL.json") - {"note"}
    assert want <= set(rec), sorted(want - set(rec))
    assert rec["stages_init_r2"] == [32.0, 2.0] and len(rec["reduced"]) == 4
    assert rec["deposits_dropped_total"] == 0 and rec["eye_dropped_total"] == 0
    assert imported == ["IMPORTED "], imported


def test_restart_study_script_on_cpu(tmp_path):
    out = tmp_path / "nr.json"
    r, imported = _run("torch_newton_restart_study.py", "--platform", "cpu", "--n", "16",
                       "--res", "4", "--out", str(out))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.load(open(out))
    assert _jax_keys("NEWTON_RESTARTS.json") <= set(rec)
    assert set(rec["pops"]) == {"eye", "photon", "grazing"}
    assert set(rec["pops"]["photon"]) == {"oracle_hits", "4", "8", "16", "32"}
    assert rec["n_rays"] == {"eye": 16, "photon": 16, "grazing": 16} and len(rec["reduced"]) == 2
    assert imported == ["IMPORTED "], imported


def test_compaction_candidates_equal_jax_nonzero():
    """The three compaction candidates at a cut of the tool's shapes equal
    ``jnp.nonzero(mask, size=cap, fill_value=N)[0]`` on the same mask (the
    tool's seed), and both deposit-key sorts equal numpy's stable sort."""
    import jax.numpy as jnp

    N, cap, D = 8192, 410, 5000
    res = compact.measure(N, cap, D, 2, torch.device("cpu"))
    assert res["outputs_identical"] and set(res["compaction"]) == {"nonzero", "argsort",
                                                                  "sortkv"}
    mask, keys = compact.inputs(N, D, "cpu")
    assert 300 < res["valid_lanes"] == int(mask.sum()) < cap
    want = np.asarray(jnp.nonzero(jnp.asarray(mask.numpy()), size=cap, fill_value=N)[0])
    for name, fn in compact.COMPACTION.items():
        np.testing.assert_array_equal(fn(mask, cap).numpy(), want, err_msg=name)
    few = compact.inputs(N, D, "cpu", frac=0.2)[0]       # more True lanes than the cap
    want = np.asarray(jnp.nonzero(jnp.asarray(few.numpy()), size=cap, fill_value=N)[0])
    for name, fn in compact.COMPACTION.items():
        np.testing.assert_array_equal(fn(few, cap).numpy(), want, err_msg=name)
    order = np.argsort(keys.numpy(), kind="stable")
    for name, fn in compact.KEY_SORT.items():
        ks, o = fn(keys)
        np.testing.assert_array_equal(o.numpy(), order, err_msg=name)
        np.testing.assert_array_equal(ks.numpy(), keys.numpy()[order], err_msg=name)


def test_depprep_candidates_agree_and_refuse_a_wrong_one():
    """Candidates a, b, c and f on JAX's inputs (cut to 4096 rows) agree,
    a equals numpy's stable sort and row gather, and the check refuses a
    candidate whose rows are shifted by one column."""
    keys, cols = depprep.synthetic(4096, "cpu")
    rng = np.random.default_rng(0)                  # JAX's script's draws, in order
    np.testing.assert_array_equal(keys.numpy(), rng.integers(0, 1 << 20, 4096))
    outs = {n: f(keys, cols) for n, f in depprep.CANDIDATES.items()}
    depprep.check_candidates(outs)
    order = np.argsort(keys.numpy(), kind="stable")
    np.testing.assert_array_equal(outs["a_rowgather16"][1].numpy(), cols.numpy()[order])
    bad = dict(outs, b_rowgather12=(outs["b_rowgather12"][0],
                                    outs["a_rowgather16"][1][:, 1:13]))
    with pytest.raises(AssertionError, match="b_rowgather12"):
        depprep.check_candidates(bad)


def test_depprep_port_prep_equals_its_row_gather_twin():
    """The port's deposit prep (``DepositTile._dep_sorted``) on one regen
    round of the bench's pass, cut to 16^2 and 512 photons, equals the
    stable sort and row gather of its keys and rows."""
    dep_fn, deps = depprep.bench_round(16, 512, torch.device("cpu"))
    info = depprep.check_prep(dep_fn, deps)
    assert info["deposits"] == 14 * 512 and 0 < info["valid"] < info["deposits"]
    assert info["padded"] % dep_fn.chunk == 0


def test_micro_benchmark_scripts_on_cpu(tmp_path):
    """The three scripts at small sizes, run at once: each writes its
    record with its keys and imports no JAX."""
    runs = {
        "dispatch": ("torch_perf_dispatch_micro.py", "--res", "16", "--rounds", "1",
                     "--photons", "256", "--issue", "1", "--ns", "1"),
        "compact": ("torch_perf_compact_micro.py", "--n", "4096", "--cap", "205", "--d",
                    "5000", "--reps", "2"),
        "depprep": ("torch_perf_depprep_micro.py", "--d", "4096", "--res", "16",
                    "--photons", "256", "--reps", "2"),
    }
    with ThreadPoolExecutor(3) as pool:
        done = {k: pool.submit(_run, v[0], *v[1:], "--platform", "cpu", "--out",
                               str(tmp_path / f"{k}.json")) for k, v in runs.items()}
    for k, fut in done.items():
        r, imported = fut.result()
        assert r.returncode == 0, (k, r.stdout[-3000:] + r.stderr[-3000:])
        assert imported == ["IMPORTED "], (k, imported)
    rec = {k: json.load(open(tmp_path / f"{k}.json")) for k in runs}
    for r in rec.values():
        assert WHERE <= set(r) and r["device"] == "cpu" and r["card"] is None and r["reduced"]
    want = {k.replace("n2_", "n1_").replace("n4_gen", "n1_gen").replace("drain_4", "drain_1")
            for k in DISPATCH_KEYS - {"wall_per_pass_n4_s", "wall_per_pass_n8_s"}}
    assert want <= set(rec["dispatch"]), sorted(want - set(rec["dispatch"]))
    assert len(rec["dispatch"]["pass_issue_s"]) == 1 and rec["dispatch"]["launches_per_pass"] is None
    assert rec["dispatch"]["drops_first_pass"] == {"dropped": 0, "deposits_dropped": 0}
    assert rec["compact"]["outputs_identical"] and set(rec["compact"]["key_sort"]) == {
        "argsort_gather", "sort_key_val"}
    c = rec["depprep"]["candidates"]
    assert rec["depprep"]["outputs_identical"] and set(c) == {
        "a_rowgather16", "b_rowgather12", "c_rowgather8", "d_varsort9", "e_varsort12",
        "f_take_along", "g_port_prep"}
    assert c["d_varsort9"]["no_counterpart"] and c["g_port_prep"]["wall_ms"] > 0


def test_tool_scripts_import_no_jax():
    """Every tooling script of the port imports torch and the port only
    (loaded as a module in a fresh interpreter, nothing run)."""
    names = ["torch_newton_restart_study", "torch_gradcheck", "torch_inverse_render",
             "torch_inverse_ctrl_anneal", "torch_reference1024", "torch_perf_trainstep",
             "torch_perf_dispatch_micro", "torch_perf_compact_micro",
             "torch_perf_depprep_micro", "torch_sharded_cards", "torch_asset_render",
             "torch_perf_bisect", "torch_perf_deposit_micro", "torch_perf_deposit_sweep"]
    code = ("import runpy, sys\n"
            f"for n in {names!r}: runpy.run_path('scripts/' + n + '.py', run_name=n)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'raytrace3_tpu'))\n"
            "assert 'raytrace3_tpu_torch' in sys.modules and not bad, bad\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr[-2000:]
