"""The asset render and the last three micro-benchmarks of the port
(``scripts/torch_asset_render.py``, ``torch_perf_bisect.py``,
``torch_perf_deposit_micro.py``, ``torch_perf_deposit_sweep.py``) on the
CPU at small sizes, against the JAX scripts they follow where those have
something to compare.

* The asset render at 16^2, one pass, on image files written as
  ``tests/test_torch_assets.py`` writes them: its scene's atlas equals
  JAX's ``scenes._atlas(asset_dir=...)`` exactly, no drop, the record has
  the keys of JAX's ``docs/ASSET_TEAPOT512.json``; a directory without the
  reference's images is refused with nothing written.
* The sweep: ``scene_points`` equals JAX's script's bit for bit on the same
  ``rng``; its 36 configurations are JAX's, in its order, with its classes
  and keywords (read from JAX's own ``main`` with its deposit classes
  replaced by recorders); a cut sweep of a capped block row, a tile row and
  a coarse-z row gives equal counts where none overflows, each row held
  to its plain twin; a selection without an uncapped row is refused, and
  a failed reference row fails the run with its record written.
* The bisect builds each variant as JAX's does (``render_pass`` recorded),
  prints every variant, records ``rbg`` as having no counterpart, and runs
  its full pass drop-free; the deposit micro runs its five stages.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (thread count)
from test_torch_assets import _asset_dir

from raytrace3_tpu_torch.testing import load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

asset = load_script("torch_asset_render")
bisect = load_script("torch_perf_bisect")
micro = load_script("torch_perf_deposit_micro")
sweep = load_script("torch_perf_deposit_sweep")

#: The port's class for each of JAX's.
PORT_CLASS = {"PallasDeposit": "DepositBlock", "PallasDepositTile": "DepositTile",
              "PallasDepositStream": "DepositStream", "PallasDepositZTile": "DepositZTile"}
CUT = ["--platform", "cpu", "--res", "16", "--passes", "1", "--rounds", "1",
       "--photons", "256", "--atlas-res", "16"]


def test_asset_render_reads_the_reference_images_as_jax(tmp_path, monkeypatch):
    from raytrace3_tpu import scenes as jscenes

    import raytrace3_tpu_torch.render.driver as driver

    monkeypatch.delenv("RT3_ASSET_TEXTURES", raising=False)
    assets = _asset_dir(tmp_path / "assets")
    seen = {}
    real_render = driver.render

    def render(cfg, scene=None, **kwargs):
        seen["atlas"] = scene.atlas
        return real_render(cfg, scene=scene, **kwargs)

    monkeypatch.setattr(driver, "render", render)
    out = tmp_path / "asset.json"
    assert asset.main([*CUT, "--assets", str(assets), "--out", str(out),
                       "--png", str(tmp_path / "asset.png")]) == 0
    want = np.asarray(jscenes._atlas(16, asset_dir=str(assets)))
    np.testing.assert_array_equal(seen["atlas"].numpy(), want)
    rec = json.load(open(out))
    with open(os.path.join(REPO, "docs", "ASSET_TEAPOT512.json")) as f:
        assert set(json.load(f)) <= set(rec)
    assert rec["asset_slots"] == {"wall": "wall.jpg", "planet": "planet.png",
                                  "blue": "blue.jpeg"}
    assert rec["dropped"] == 0 and rec["deposits_dropped"] == 0
    assert rec["device"] == "cpu" and rec["res"] == 16 and len(rec["reduced"]) == 5
    assert (tmp_path / "asset.png").exists()


@pytest.mark.parametrize("files", [[], ["blue.jpeg"]], ids=["empty", "blue-only"])
def test_asset_render_refuses_a_directory_without_the_reference_images(tmp_path, files,
                                                                       monkeypatch):
    monkeypatch.delenv("RT3_ASSET_TEXTURES", raising=False)
    assets = tmp_path / "assets"
    assets.mkdir()
    for name in files:
        (assets / name).write_bytes(b"")
    out, png = tmp_path / "asset.json", tmp_path / "asset.png"
    assert asset.main([*CUT, "--assets", str(assets), "--out", str(out),
                       "--png", str(png)]) == 2
    assert not out.exists() and not png.exists()
    assert asset.main([*CUT, "--out", str(out)]) == 2          # no --assets at all
    assert "RT3_ASSET_TEXTURES" not in os.environ


def test_sweep_scene_points_equal_jax():
    jax_sweep = load_script("perf_deposit_sweep")
    for seed, n in ((0, 1000), (7, 4097)):
        got = sweep.scene_points(np.random.default_rng(seed), n)
        want = jax_sweep.scene_points(np.random.default_rng(seed), n)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_sweep_configurations_are_jax(monkeypatch, capsys):
    """JAX's ``main`` with its four deposit classes replaced by recorders
    whose ``prepare`` raises: it prints each configuration's name (its
    error row) in order, and the recorders keep each class and its
    keywords."""
    import raytrace3_tpu.ops.deposit_pallas as dp

    jax_sweep = load_script("perf_deposit_sweep")
    built = []

    class Recorded:
        def prepare(self, hp):
            raise RuntimeError("recorded")

    def recorder(name):
        def make(**kw):
            kw.pop("interpret")
            built.append((PORT_CLASS[name], kw))
            return Recorded()
        return make

    for name in PORT_CLASS:
        monkeypatch.setattr(dp, name, recorder(name))
    monkeypatch.setenv("RT3_SWEEP_D", "64")
    monkeypatch.setenv("RT3_SWEEP_C", "64")
    monkeypatch.delenv("RT3_SWEEP", raising=False)
    assert jax_sweep.main() == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    ours = sweep.configs()
    assert [r["cfg"] for r in rows] == [n for n, _, _ in ours] and len(ours) == 36
    for (name, cls, kw), (jcls, jkw) in zip(ours, built):
        kw = dict(kw)
        assert kw.pop("packed", False) == ("packed" in name)
        assert (cls, kw) == (jcls, jkw), name


def test_cut_sweep_rows_agree():
    """A capped block row, an uncapped tile row and a coarse-z row on JAX's
    inputs cut to 4096 deposits and 2048 hit points: none overflows, every
    row's counts equal the reference tile row's, and each row holds to its
    plain twin summed in float64."""
    names = ("1d_t512_wc1024_W16k", "tile1d_t128_ch1024", "ztile_zc8.0_t128_ch1024_packed")
    rows = [r for r in sweep.configs() if r[0] in names]
    res = sweep.sweep(rows, 4096, 2048, 1, torch.device("cpu"))
    assert res["counts_reference"] == "tile1d_t128_ch1024" and res["all_rows_ok"]
    assert res["pairs_counted"] > 0
    for r in res["rows"]:
        assert r["overflow"] == 0 and r["counts_equal_reference"], r["cfg"]
        assert ("items" in r) == (r["class"] != "DepositBlock")
        assert r["holds_twin"] and r["twin_count_mismatch"] == 0 and r["twin_pairs"] > 0
        assert r["twin_flux_rel"] <= sweep.TWIN_FLUX_RTOL


@pytest.mark.parametrize("case", ["only-capped", "reference-fails"])
def test_sweep_without_a_reference(tmp_path, monkeypatch, case):
    """``--only 0`` (capped rows only) is refused before any row runs, with
    nothing written; when the reference row fails, the record is written
    and the run exits 1."""
    out = tmp_path / "sweep.json"
    args = ["--platform", "cpu", "--d", "512", "--c", "256", "--reps", "1", "--out", str(out)]
    if case == "only-capped":
        with pytest.raises(SystemExit) as e:
            sweep.main(["--only", "0", *args])
        assert e.value.code == 2 and not out.exists()
        return
    make = sweep.make_deposit

    def failing(cls_name, kw):
        if cls_name == "DepositTile":
            raise RuntimeError("the reference row fails")
        return make(cls_name, kw)

    monkeypatch.setattr(sweep, "make_deposit", failing)
    assert sweep.main(["--only", "0,1", *args]) == 1
    rec = json.load(open(out))
    assert not rec["all_rows_ok"] and rec["pairs_counted"] is None
    assert "error" in rec["rows"][1] and "counts_equal_reference" not in rec["rows"][0]


def test_bisect_builds_and_prints_every_variant(tmp_path, capsys, monkeypatch):
    """Every variant's pass, with ``render_pass`` replaced by a recorder:
    what each turns off (JAX's meaning), one printed line a variant in
    order, ``rbg`` recorded as having no counterpart."""
    import raytrace3_tpu_torch.render.sppm as sppm

    calls = []

    def record(scene, org, dirs, rng, **kw):
        calls.append(kw)
        return torch.zeros((org.shape[0], 3)), {"dropped": 0, "deposits_dropped": 0}

    monkeypatch.setattr(sppm, "render_pass", record)
    out = tmp_path / "bisect.json"
    assert bisect.main(["--platform", "cpu", "--res", "8", "--rounds", "2", "--photons", "128",
                        "--passes", "1", "--out", str(out)]) == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [p["variant"] for p in printed] == list(bisect.VARIANTS)
    assert len(calls) == 2 * 6                          # a first and a timed pass each
    kw = dict(zip([v for v in bisect.VARIANTS if v != "rbg"], calls[::2]))
    full = kw["full"]
    assert type(full["deposit_fn"]).__name__ == "DepositBlock" and full["n_rounds"] == 2
    assert full["deposit_fn"].tile == 512 and full["deposit_fn"].work_cap == 16384
    assert full["newton_fn"] is None and full["deposit_compact_frac"] == 0.9
    assert full["photon_scene"].bezier_compact_frac == 0.05
    assert kw["nodeposit"]["deposit_fn"] is bisect.zero_deposit
    assert bool((kw["notex"]["photon_scene"].obj_tex == -1).all())
    assert bool((full["photon_scene"].obj_tex >= 0).any())
    assert kw["nobezier"]["photon_scene"].bezier is None
    assert kw["nonewton"]["newton_fn"] is bisect.never_hit
    assert kw["eyeonly"]["n_rounds"] == 1
    rec = json.load(open(out))
    assert list(rec["variants"]) == list(bisect.VARIANTS)
    assert set(rec["variants"]["rbg"]) == {"no_counterpart"}
    assert all("share_of_full" in r for v, r in rec["variants"].items()
               if v not in ("full", "rbg"))


def test_bisect_full_pass_on_cpu(tmp_path):
    out = tmp_path / "bisect.json"
    assert bisect.main(["full", "--platform", "cpu", "--res", "8", "--rounds", "1",
                        "--photons", "128", "--passes", "1", "--out", str(out)]) == 0
    rec = json.load(open(out))
    full = rec["variants"]["full"]
    assert full["dropped"] == 0 and full["deposits_dropped"] == 0 and full["image_finite"]
    assert len(full["pass_seconds_each"]) == 1 and full["device_events_per_pass"] is None
    assert rec["device"] == "cpu" and "passes 2 -> 1" in rec["reduced"]
    assert any(r.startswith("variants ") for r in rec["reduced"])


def test_deposit_micro_stages_run(tmp_path):
    out = tmp_path / "micro.json"
    assert micro.main(["--platform", "cpu", "--d", "4096", "--c", "2048", "--reps", "1",
                       "--out", str(out)]) == 0
    rec = json.load(open(out))
    assert list(rec["stages"]) == ["compact_nonzero_gather", "argsort_keys",
                                   "row_gather_transpose", "block_deposit_full",
                                   "prepare_once_per_pass"]
    assert all(s["wall_ms"] > 0 and s["device_ms"] is None for s in rec["stages"].values())
    block = rec["stages"]["block_deposit_full"]
    assert rec["dc"] == int(4096 * 0.9) and block["overflow"] == 0 and block["pairs_taken"] > 0
    assert rec["device"] == "cpu" and len(rec["reduced"]) == 3
