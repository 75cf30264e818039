"""The port's CLI (``python -m raytrace3_tpu_torch.cli``) against the JAX
package's ``rt3``: a smoke render on the CPU (tests/test_driver.py:52), the
presets, and for every ``--deposit`` choice at both sizes the backend it
builds, held to the one JAX's ``main`` builds from the same flags (both
mains run with their ``render`` replaced by a stub that keeps its
arguments).
"""

import numpy as np
import pytest
from PIL import Image

from raytrace3_tpu import cli as jcli
from raytrace3_tpu.ops.deposit_pallas import (PallasDeposit, PallasDepositLane,
                                              PallasDepositTile)
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.utils.config import PRESETS as J_PRESETS

from raytrace3_tpu_torch import cli
from raytrace3_tpu_torch.ops.deposit_kernel import DepositBlock, DepositTile
from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
from raytrace3_tpu_torch.render import driver
from raytrace3_tpu_torch.utils.config import PRESETS, get_config


def test_cli_smoke_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "o.png"
    rc = cli.main(["--platform", "cpu", "--scene", "cornell_diffuse", "--res", "16",
                   "--passes", "1", "--rounds", "1", "--photons", "256", "--depth", "3",
                   "--out", str(out)])
    assert rc == 0
    assert Image.open(out).size == (16, 16)
    assert "passes=1" in capsys.readouterr().out


def test_presets_exist():
    assert sorted(PRESETS) == sorted(J_PRESETS)
    for name in ["cornell128", "specular256", "bezier256", "teapot512", "sharded10m",
                 "reference1024"]:
        cfg = get_config(name)
        assert cfg.n_pixels > 0
        assert vars(cfg) == vars(J_PRESETS[name])
    ref = get_config("reference1024")
    assert (ref.deposit, ref.use_pallas, ref.hitpoint_capacity > cli.BIG_CAPACITY) == \
        ("pallas", True, True)


def test_sharded_flags_exit_nonzero(capsys):
    for flag in ("--sharded", "--hp-sharded"):
        assert cli.main([flag, "--platform", "cpu"]) != 0
        assert "Slice D" in capsys.readouterr().err


def test_no_card_and_no_cpu_flag_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--scene", "cornell_diffuse", "--res", "8", "--passes", "1"])


def _built(monkeypatch, tmp_path, argv):
    """(port (newton_fn, deposit_fn), JAX's) built by each main from argv."""
    seen = {}

    def stub(key):
        def render(cfg, **kw):
            seen[key] = (kw["newton_fn"], kw["deposit_fn"], cfg)
            return np.zeros((cfg.height, cfg.width, 3), np.float32), {"meter": {}}
        return render

    monkeypatch.setattr(driver, "render", stub("port"))
    monkeypatch.setattr(jdriver, "render", stub("jax"))
    out = ["--out", str(tmp_path / "o.png")]
    assert cli.main(argv + out + ["--platform", "cpu"]) == 0
    assert jcli.main(argv + out) == 0
    return seen["port"], seen["jax"]


COUNTERPART = {PallasDeposit: DepositBlock, PallasDepositLane: DepositLane,
               PallasDepositTile: DepositTile}


@pytest.mark.parametrize("res", [16, 1024])
@pytest.mark.parametrize("deposit", ["bruteforce", "grid", "pallas", "lane", "tile"])
def test_backend_choice_matches_jax(monkeypatch, tmp_path, deposit, res):
    argv = ["--scene", "full", "--res", str(res), "--passes", "0", "--deposit", deposit]
    (p_newton, p_dep, p_cfg), (j_newton, j_dep, j_cfg) = _built(monkeypatch, tmp_path, argv)
    assert vars(p_cfg) == vars(j_cfg)
    assert (p_cfg.hitpoint_capacity > cli.BIG_CAPACITY) == (res == 1024)
    assert p_newton is None and j_newton is None           # solve_winner on both
    if deposit == "bruteforce":
        assert p_dep is None and j_dep is None
    elif deposit == "grid":
        assert p_dep.returns_aux and j_dep.returns_aux
        assert p_dep.__qualname__.startswith("make_grid_deposit")
    else:
        assert type(p_dep) is COUNTERPART[type(j_dep)]
        shared = ["tile", "work_cap", "bucket2d", "n_bx", "n_bz", "n_buckets", "y_stride",
                  "x_lo", "y_lo", "z_lo", "win_offs", "win_offs_lo", "win_offs_hi"]
        for a in shared + (["wchunk"] if deposit == "pallas" else ["chunk"]):
            if a == "work_cap" and deposit == "tile":
                continue                                    # the tile loop has no cap
            assert getattr(p_dep, a) == getattr(j_dep, a), a


def test_pallas_flag_picks_the_newton_kernel(monkeypatch, tmp_path):
    argv = ["--scene", "full", "--res", "8", "--passes", "0", "--pallas"]
    (p_newton, _, _), (j_newton, _, _) = _built(monkeypatch, tmp_path, argv)
    assert p_newton.func.__name__ == "solve" and p_newton.keywords["restarts"] == 8
    assert j_newton is not None
