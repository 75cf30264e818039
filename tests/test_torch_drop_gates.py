"""F4: every port entry point and script that records a run refuses one
that lost flux, whichever of the two drop counters is non-zero.

Seven sites count the eye's ``dropped`` and the deposits'
``deposits_dropped``: the dry run's train step and the six scripts that
write a ``docs/*_PORT.json`` from renders (the train-step timing, the
crossval, reference1024, inverse rendering, the grad check and the anneal).
Each case feeds one site a non-zero counter through the source its stats
come from (monkeypatched: no full render runs) and expects the refusal,
``utils.metrics.LostFlux`` from the dry run and exit code
``LOST_FLUX_EXIT`` (3, not the criterion's 1) from a script, with no
record written; the case without a drop writes the record, so the gate is
what refused.  JAX's scripts have the same gaps and stay as they are.
"""

import json

import pytest
import torch

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu_torch.testing import load_script
from raytrace3_tpu_torch.utils.metrics import LOST_FLUX_EXIT, LostFlux

COUNTERS = [None, "dropped", "deposits_dropped"]


def _stats(counter, calls):
    """Both counters 0, except ``counter`` at 1 on the first call."""
    stats = {"dropped": 0, "deposits_dropped": 0}
    if counter and not calls:
        stats[counter] = 1
    calls.append(1)
    return stats


def _fake_render_fn(counter):
    """A ``diff.train.make_render_fn`` whose render returns, at once, an
    image that depends smoothly on every parameter, and its stats."""
    calls = []

    def make_render_fn(scene, cfg, *args, **kwargs):
        def render(params, gen):
            s = sum((v.float() ** 2).mean() for v in params.values())
            return s * torch.ones((cfg.height * cfg.width, 3)), _stats(counter, calls)
        return render
    return make_render_fn


def _dryrun(monkeypatch, tmp_path, counter):
    from raytrace3_tpu_torch.parallel import dryrun, shard

    calls = []
    monkeypatch.setattr(shard, "make_sharded_pass_fn", lambda *a, **k: (
        lambda *gens: (torch.ones((16, 16, 3)), _stats(None, []))))
    train_step = dryrun.train_step

    def fake_train_step(mesh):
        cfg, scene, init_fn, _ = train_step(mesh)

        def step(params, opt, rng, target):
            for v in params.values():
                v.grad = torch.ones_like(v)
            return params, opt, torch.tensor(0.5), _stats(counter, calls)
        return cfg, scene, init_fn, step

    monkeypatch.setattr(dryrun, "train_step", fake_train_step)
    if counter is None:
        assert dryrun.dryrun("cpu")["train"] == {"dropped": 0, "deposits_dropped": 0}
        return
    with pytest.raises(LostFlux, match=f"train step: {counter} = 1"):
        dryrun.dryrun("cpu")


def _trainstep(monkeypatch, tmp_path, counter):
    import raytrace3_tpu_torch.diff.train as train

    calls = []

    def fake_make_train_step(scene, cfg, **kwargs):
        step = lambda params, opt, gen, target: (params, opt, torch.tensor(0.1),
                                                 _stats(counter, calls))
        return (lambda params: None), step

    monkeypatch.setattr(train, "make_train_step", fake_make_train_step)
    return load_script("torch_perf_trainstep").main, [
        "--res", "8", "--steps", "1", "--rounds", "1", "--photons", "64"]


def _crossval(monkeypatch, tmp_path, counter):
    import numpy as np

    cv = load_script("torch_crossval")
    calls = []

    def run_cpp(res, photons, dump, **kwargs):
        np.ones((res, res, 3), np.float32).tofile(dump)
        return {}

    monkeypatch.setattr(cv, "run_cpp", run_cpp)
    monkeypatch.setattr(cv, "build", lambda res, photons, *a: (
        None, None, lambda gen: (torch.ones((res * res, 3)), _stats(counter, calls)),
        photons))
    return cv.main, ["--res", "8", "--photons", "64", "--block", "4",
                     "--png", str(tmp_path / "cv.png")]


def _reference1024(monkeypatch, tmp_path, counter):
    import raytrace3_tpu_torch.cli as cli

    calls = []

    def fake_main(flags):
        with open(flags[flags.index("--metrics-jsonl") + 1], "w") as f:
            for i in range(2):
                f.write(json.dumps({"pass": i + 1, "pass_seconds": 1.0, "photons_per_s": 1.0,
                                    "mrays_per_s": 1.0, "hitpoints": 1, "mean_r2": 1.0,
                                    **_stats(counter, calls)}) + "\n")
        return 0

    monkeypatch.setattr(cli, "main", fake_main)
    return load_script("torch_reference1024").main, [
        "--passes", "2", "--png", str(tmp_path / "r.png"),
        "--metrics", str(tmp_path / "m.jsonl")]


def _inverse(monkeypatch, tmp_path, counter):
    import raytrace3_tpu_torch.diff.train as train

    monkeypatch.setattr(train, "make_render_fn", _fake_render_fn(counter))
    return load_script("torch_inverse_render").main, [
        "--exp", "albedo", "--res", "8", "--photons", "64", "--steps", "1",
        "--png", str(tmp_path / "inv.png")]


def _gradcheck(monkeypatch, tmp_path, counter):
    gc = load_script("torch_gradcheck")
    calls = []
    monkeypatch.setattr(gc, "run", lambda column, *a: (
        {"diff": [{"coord": [0], "fd": 1.0, "ad": 1.0, "pass": True}]},
        _stats(counter, calls)))
    return gc.main, ["--columns", "plain"]


def _anneal(monkeypatch, tmp_path, counter):
    import raytrace3_tpu_torch.diff.train as train

    monkeypatch.setattr(train, "make_render_fn", _fake_render_fn(counter))
    return load_script("torch_inverse_ctrl_anneal").main, [
        "--res", "8", "--photons", "64", "--stages", "2", "--steps-per-stage", "1",
        "--png", str(tmp_path / "an.png")]


SITES = {"dryrun": _dryrun, "perf_trainstep": _trainstep, "crossval": _crossval,
         "reference1024": _reference1024, "inverse_render": _inverse,
         "gradcheck": _gradcheck, "inverse_ctrl_anneal": _anneal}


@pytest.mark.parametrize("counter", COUNTERS, ids=["none", "dropped", "deposits_dropped"])
@pytest.mark.parametrize("site", sorted(SITES))
def test_site_refuses_a_run_that_lost_flux(monkeypatch, tmp_path, site, counter):
    script = SITES[site](monkeypatch, tmp_path, counter)
    if script is None:                        # the dry run raised, or returned
        return
    main, args = script
    out = tmp_path / "record.json"
    argv = [*args, "--platform", "cpu", "--out", str(out)]
    if counter is None:
        assert main(argv) in (0, 1)           # 1: a recovery's criterion
        assert out.exists()
        return
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == LOST_FLUX_EXIT
    assert not out.exists()

