"""The multi-pass driver and the files it writes, against the JAX
package's (tests/test_driver.py's cases on the port), and the slice as a
whole: a 2-pass render through ``DepositBlock`` held to JAX's.

On the CPU the port's passes are deterministic, so a resumed render equals
the uninterrupted one bit for bit (JAX's test asks rtol 1e-6).  The PNG
writer uses only the standard library; PIL, present here, reads it back.

The slice: scene ``full`` at 24 x 24, 2 passes of 2 rounds x 512 photons,
the ``reference1024`` preset's path (regen walk, staged eye schedule,
Bezier compaction 0.09 / 0.05, hit-point factor 1.3, the block deposit and
the Newton kernel at 8 restarts) cut to size.  JAX's ``driver.render`` runs
with ``PallasDeposit`` and the Newton kernel in interpret mode and its walks
recorded; the port's ``render`` is handed each pass's JAX draws
(``fold_in(key(seed), i)``) and its walks are held to JAX's one segment at a
time (``raytrace3_tpu_torch.testing``).  Per-pass counters must be equal,
``photons_emitted`` included, and the mean image within 1e-5 relative L1
(the deposit counts are exact; flux sums differ in order only).
"""

import json
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import jax_walk_steps, pass_draws
from raytrace3_tpu.ops.deposit_pallas import PallasDeposit
from raytrace3_tpu.ops.deposit_pallas import world_bounds_from_scene as j_bounds
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.utils import checkpoint as jckpt
from raytrace3_tpu.utils import image as jimage
from raytrace3_tpu.utils.config import RenderConfig as JConfig

from raytrace3_tpu_torch.core.sampling import ReplayDraws
from raytrace3_tpu_torch.ops import deposit_kernel
from raytrace3_tpu_torch.ops.deposit_kernel import DepositBlock, world_bounds_from_scene
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import driver
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments
from raytrace3_tpu_torch.utils import checkpoint, image
from raytrace3_tpu_torch.utils.config import RenderConfig

TINY = RenderConfig(scene="cornell_diffuse", width=24, height=24, passes=3, rounds=2,
                    photons_per_round=512, max_depth=4, atlas_res=16)


def _render(cfg, **kw):
    return driver.render(cfg, device="cpu", **kw)


def test_render_deterministic():
    img1, m1 = _render(TINY)
    img2, _ = _render(TINY)
    np.testing.assert_array_equal(img1, img2)
    assert img1.shape == (24, 24, 3) and img1.dtype == np.float32
    assert np.isfinite(img1).all() and img1.max() > 0
    assert m1["meter"]["passes"] == 3 and m1["count"] > 0 and m1["dropped"] == 0
    assert isinstance(m1["count"], int) and isinstance(m1["mean_r2"], float)


def test_checkpoint_resume_is_bitwise(tmp_path):
    ck = str(tmp_path / "ck.npz")
    full_img, _ = _render(TINY)
    _render(TINY.replace(passes=1, checkpoint_every=1), checkpoint_path=ck)
    assert checkpoint.load(ck)[1] == 1
    resumed, m = _render(TINY.replace(checkpoint_every=1), checkpoint_path=ck)
    np.testing.assert_array_equal(resumed, full_img)
    assert m["meter"]["passes"] == 2                   # passes 2 and 3 ran
    accum, done, seed, extra = checkpoint.load(ck)
    assert (done, seed, extra) == (3, 0, {})
    with pytest.raises(ValueError, match="seed"):
        _render(TINY.replace(seed=5), checkpoint_path=ck)


def test_seed_changes_image_and_two_lights_render():
    img1, _ = _render(TINY.replace(passes=1))
    img2, _ = _render(TINY.replace(passes=1, seed=123))
    assert np.abs(img1 - img2).max() > 1e-6
    img, m = _render(TINY.replace(scene="cornell_two_lights", passes=1))
    assert np.isfinite(img).all() and img.max() > 0
    assert m["photons_emitted"] == TINY.rounds * TINY.photons_per_round


def test_metrics_jsonl_preview_and_profile(tmp_path):
    jl, out, prof = tmp_path / "m.jsonl", tmp_path / "p.png", tmp_path / "prof"
    img, m = _render(TINY.replace(out=str(out)), metrics_jsonl=str(jl), preview_every=2,
                     profile_dir=str(prof))
    recs = [json.loads(line) for line in jl.read_text().splitlines()]
    assert [r["pass"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert set(r) == {"pass", "pass_seconds", "photons_per_s", "mrays_per_s",
                          "hitpoints", "dropped", "deposits_dropped", "mean_r2"}
        assert r["hitpoints"] == m["count"] and r["deposits_dropped"] == 0
    assert Image.open(out).size == (24, 24)
    assert [p.name for p in prof.iterdir()] == ["pass1.trace.json"]
    assert set(m["meter"]) == {"passes", "total_seconds", "photons_per_s", "mrays_per_s"}


def test_psnr_and_mse_match_jax():
    a = np.zeros((4, 4, 3))
    b = np.ones((4, 4, 3)) * 0.1
    assert abs(image.mse(a, b) - 0.01) < 1e-12
    assert abs(image.psnr(a, b) - 20.0) < 1e-9
    assert image.psnr(a, a) == float("inf")
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 2, (5, 7, 3)), rng.uniform(0, 2, (5, 7, 3))
    assert image.mse(x, y) == jimage.mse(x, y)
    assert image.psnr(x, y, 2.0) == jimage.psnr(x, y, 2.0)


def test_png_is_the_reference_tone_map_flipped(tmp_path):
    img = np.random.default_rng(1).uniform(0, 4, (13, 21, 3)).astype(np.float32)
    img[0, 0] = [-1.0, 0.0, 50.0]
    np.testing.assert_array_equal(image.to_uint8(img), jimage.to_uint8(img))
    path = tmp_path / "a.png"
    image.save_png(str(path), img)
    back = np.asarray(Image.open(path))
    assert back.shape == (13, 21, 3) and back.dtype == np.uint8
    np.testing.assert_array_equal(back, jimage.to_uint8(img)[::-1])
    jpath = tmp_path / "b.png"
    jimage.save_png(str(jpath), img)
    np.testing.assert_array_equal(back, np.asarray(Image.open(jpath)))
    raw = path.read_bytes()                 # the standard-library encoder
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", raw[16:24]) == (21, 13)
    assert struct.unpack(">I", raw[29:33])[0] == zlib.crc32(raw[12:29])


def test_checkpoints_cross_load(tmp_path):
    acc = np.random.default_rng(2).uniform(0, 1, (6, 5, 3)).astype(np.float32)
    mine, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    checkpoint.save(mine, acc, 4, 7, {"note": "port"})
    jckpt.save(theirs, acc, 4, 7, {"note": "jax"})
    for got, note in ((jckpt.load(mine), "port"), (checkpoint.load(theirs), "jax")):
        np.testing.assert_array_equal(got[0], acc)
        assert got[0].dtype == np.float32 and got[1:] == (4, 7, {"note": note})
    assert checkpoint.load(str(tmp_path / "none.npz")) is None
    assert not any(p.name.endswith(".tmp.npz") for p in tmp_path.iterdir())


SLICE = dict(scene="full", width=24, height=24, passes=2, rounds=2, photons_per_round=512,
             max_depth=13, atlas_res=32, bezier_compact_frac=0.09,
             bezier_compact_frac_photon=0.05, newton_iters=10, hitpoint_factor=1.3,
             photon_regen=True, eye_compact_schedule=((1, 0.3), (4, 0.055), (6, 0.028)))
#: tile 64 / wchunk 128 / work cap 1024: the block deposit at test size.
BLOCK = dict(tile=64, wchunk=128, work_cap=1024)
XY = ("x_lo", "x_hi", "y_lo", "y_hi")
L1_RTOL = 1e-5


def test_render_slice_matches_jax(tmp_path):
    cfg_j = JConfig(**SLICE)
    scene_j = jdriver.build_scene(cfg_j)
    b = j_bounds(scene_j, extra_points=[driver.CAMERA_POS])
    with jax_walk_steps() as steps:
        img_j, st_j = jdriver.render(
            cfg_j, scene=scene_j, metrics_jsonl=str(tmp_path / "j.jsonl"),
            deposit_fn=PallasDeposit(interpret=True, **BLOCK, **{k: b[k] for k in XY}),
            newton_fn=make_newton_pallas(iters=10, restarts=8, interpret=True))

    cfg = RenderConfig(**SLICE)
    scene = driver.build_scene(cfg, device="cpu")
    pb = world_bounds_from_scene(scene, extra_points=[driver.CAMERA_POS])
    base = jax.random.key(cfg.seed)
    draws = [ReplayDraws(pass_draws(jax.random.fold_in(base, i), cfg.rounds,
                                    cfg.photons_per_round, cfg.max_depth + 1))
             for i in range(cfg.passes)]
    before = deposit_kernel.BLOCK_KERNEL.launches
    with pinned_segments(steps["eye"], steps["photon"]) as report:
        img_p, st_p = driver.render(
            cfg, scene=scene, metrics_jsonl=str(tmp_path / "p.jsonl"),
            deposit_fn=DepositBlock(**BLOCK, **{k: pb[k] for k in XY}),
            newton_fn=make_newton(10, 8), pass_rng=lambda i: draws[i])
    print("jax", st_j, "\nport", st_p, "\n", report)
    assert all(d.remaining == 0 for d in draws)
    assert deposit_kernel.BLOCK_KERNEL.launches == before      # the plain twin
    assert report.segments == {"eye": 2 * 14, "photon": 2 * 2 * 14}
    assert report.lanes["self-hit flip"] <= MAX_FLIPS

    rec = lambda name: [json.loads(x) for x in (tmp_path / name).read_text().splitlines()]
    keys = ("pass", "hitpoints", "dropped", "deposits_dropped")
    assert [[r[k] for k in keys] for r in rec("p.jsonl")] == \
        [[r[k] for k in keys] for r in rec("j.jsonl")]
    for k in ("count", "dropped", "deposits_dropped", "photons_emitted"):
        assert st_p[k] == st_j[k], k
    assert st_j["count"] > 500 and st_j["deposits_dropped"] == 0
    np.testing.assert_allclose(st_p["mean_r2"], st_j["mean_r2"], rtol=1e-6)
    assert img_p.shape == img_j.shape == (24, 24, 3) and np.isfinite(img_p).all()
    l1 = np.abs(img_p - img_j).sum() / np.abs(img_j).sum()
    print(f"relative L1 {l1:.3g}")
    assert l1 <= L1_RTOL
