"""The whole slice: the port's ``make_pass_fn`` against the JAX package's,
with the two Pallas kernels in interpret mode on the JAX side and the
port's plain twins on the CPU.

Settings are the bench's main path cut to 32 x 32 and 2 rounds x 1024
photons: scene ``full``, depth 13, regen walk, Bezier compaction 0.09 /
0.05, the eye schedule ((1, .25), (4, .04), (6, .02)), the tile deposit at
tile 256 with 1-D banding, Newton at 8 restarts x 10 iterations.  JAX's
draws for the pass (camera jitter first, then every round's walk) are
replayed into the port.

Both walks are held to JAX's one segment at a time
(``raytrace3_tpu_torch.testing``; tests/test_torch_eye.py and
tests/test_torch_photon.py hold them the same way): each of the port's
segments runs on JAX's state for that segment, is checked lane by lane,
and hands JAX's output on.  Without that, last-bit rounding differences
grow chaotically along the walks: JAX's own jitted pass and the same pass
recorded differ by 2 in ``photons_emitted`` and by ~5% in relative L1.
Held so, the deposit stage (plain twin vs the Pallas kernel), the radius
updates and the estimate run on identical hit points and deposits: the
counters, ``photons_emitted`` included, must be equal, and the image must
agree within L1_RTOL relative L1 (the deposit counts are exact, the flux
sums differ in summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_walk_steps, pass_draws
from raytrace3_tpu.ops.deposit_pallas import PallasDepositTile
from raytrace3_tpu.ops.deposit_pallas import world_bounds_from_scene as j_bounds
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.core.types import make_hitpoints as j_make_hitpoints
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.render import sppm as jsppm
from raytrace3_tpu.utils.config import RenderConfig as JaxConfig

from raytrace3_tpu_torch.convert import flatten_to_numpy, hitpoints_from_numpy
from raytrace3_tpu_torch.core.sampling import ReplayDraws
from raytrace3_tpu_torch.ops.deposit_kernel import (make_tile_deposit,
                                                    world_bounds_from_scene)
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import driver, sppm
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments
from raytrace3_tpu_torch.utils.config import RenderConfig

SETTINGS = dict(scene="full", width=32, height=32, passes=1, rounds=2,
                photons_per_round=1024, max_depth=13, atlas_res=32,
                bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
                newton_iters=10, hitpoint_factor=1.3, photon_regen=True,
                eye_compact_schedule=((1, 0.25), (4, 0.04), (6, 0.02)))
BASE = np.array([50.0, 35.0, 230.0])
LOOK = BASE + np.array([0.0, 0.042612, -1.0])
BOUNDS = ("x_lo", "x_hi", "y_lo", "y_hi")
L1_RTOL = 1e-5


def _jax_pass(key):
    cfg = JaxConfig(**SETTINGS)
    scene = jdriver.build_scene(cfg)
    b = j_bounds(scene, extra_points=[BASE])
    dep = PallasDepositTile(tile=256, chunk=2048, bucket2d=False, interpret=True,
                            **{k: b[k] for k in BOUNDS})
    fn = jdriver.make_pass_fn(scene, cfg, BASE, LOOK, deposit_fn=dep,
                              newton_fn=make_newton_pallas(iters=10, restarts=8,
                                                           interpret=True))
    with jax_walk_steps() as steps:
        img, stats = fn(key)
        jax.block_until_ready(img)
    return np.asarray(img), {k: float(v) for k, v in stats.items()}, steps


def _port_pass(key, steps):
    cfg = RenderConfig(**SETTINGS)
    scene = driver.build_scene(cfg, device="cpu")
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    fn = driver.make_pass_fn(scene, cfg, BASE, LOOK,
                             deposit_fn=make_tile_deposit(**{k: b[k] for k in BOUNDS}),
                             newton_fn=make_newton(10, 8))
    draws = ReplayDraws(pass_draws(key, cfg.rounds, cfg.photons_per_round,
                                   cfg.max_depth + 1))
    with pinned_segments(steps["eye"], steps["photon"]) as report:
        img, stats = fn(draws)
    assert draws.remaining == 0
    return img.numpy(), {k: float(v) for k, v in stats.items()}, report


def test_pass_matches_jax_with_replayed_draws():
    key = jax.random.key(0)
    img_j, st_j, steps = _jax_pass(key)
    img_p, st_p, report = _port_pass(key, steps)
    print("jax", st_j, "\nport", st_p, "\n", report)
    assert report.segments == {"eye": 14, "photon": 2 * 14}
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    assert len(steps["eye"]) == 14 and len(steps["photon"]) == 2 * 14

    assert img_p.shape == img_j.shape == (32, 32, 3)
    assert np.isfinite(img_p).all()
    for k in ("count", "dropped", "deposits_dropped", "photons_emitted"):
        assert st_p[k] == st_j[k], k
    assert st_j["count"] > 900 and st_j["deposits_dropped"] == 0
    np.testing.assert_allclose(st_p["mean_r2"], st_j["mean_r2"], rtol=1e-6)
    l1 = np.abs(img_p - img_j).sum() / np.abs(img_j).sum()
    print(f"relative L1 {l1:.3g}")
    assert l1 <= L1_RTOL


@pytest.mark.parametrize("mode", ["sppm", "reference"])
def test_ppm_update_arrays_match_jax(rng, mode):
    """The radius update, elementwise (float32; rtol 1e-6 for XLA's fused
    multiply-adds)."""
    C = 500
    args = [rng.uniform(0.1, 2.0, C), rng.uniform(0, 5, (C, 3)),
            rng.integers(0, 4, C).astype(float), rng.integers(0, 3, C).astype(float),
            rng.uniform(0, 5, (C, 3))]
    args = [a.astype(np.float32) for a in args]
    got = sppm.ppm_update_arrays(*map(torch.as_tensor, args), mode=mode)
    want = jsppm.ppm_update_arrays(*map(jnp.asarray, args), mode=mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_estimate_image_and_tonemap_match_jax(rng):
    """The pixel estimate and the 8-bit tone map, elementwise (rtol 1e-6:
    the same sums in another order)."""
    C, n_pix = 300, 64
    hp = j_make_hitpoints(C, 2.0).replace(
        pixel=jnp.asarray(rng.integers(0, n_pix, C), jnp.int32),
        valid=jnp.asarray(rng.uniform(size=C) > 0.2),
        r2=jnp.asarray(rng.uniform(0.2, 2.0, C), jnp.float32),
        tao=jnp.asarray(rng.uniform(0, 50, (C, 3)), jnp.float32))
    want = np.asarray(jsppm.estimate_image(hp, n_pix, 1000.0))
    got = sppm.estimate_image(hitpoints_from_numpy(flatten_to_numpy(hp)), n_pix,
                              torch.tensor(1000.0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    x = np.concatenate([want.ravel() * 50, [0.0, -1.0, 1e-4, 30.0]]).astype(np.float32)
    np.testing.assert_array_equal(sppm.tonemap(torch.as_tensor(x)).numpy(),
                                  np.asarray(jsppm.tonemap(jnp.asarray(x))))
