"""Photon walks: one round of the port's ``photon_trace_regen``, and one
static-walk round (``emit_photons`` + ``photon_trace``), vs the JAX
package's on ``full`` (photon-pass compaction 0.05, the Newton kernel
contract at 8 restarts on both sides), with JAX's own draws replayed into
the port (derived with JAX's split structure, tests/torch_port_util.py).

The walk is held to JAX's one segment at a time
(``raytrace3_tpu_torch.testing``): each of the port's segments runs on
JAX's lane state for that segment (origin, direction, flux, alive, depth,
refill offset, emitted), every decision must agree exactly (deposit
validity, refill, alive, depth, per-light ``emitted``) and every float to
the stated tolerances, lane by lane, and JAX's output is carried on.  The
round's deposits, final state and ``emitted`` then equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (jax_walk_steps, port_scene, regen_round_draws,
                             static_round_draws)
from raytrace3_tpu import scenes as jscenes
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import light as jlight
from raytrace3_tpu.render import photon as jphoton

from raytrace3_tpu_torch.core.sampling import ReplayDraws
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import light, photon
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments

N = 1024
SEGS = 14
#: A second light for the round-robin refill (photon.py:186-192).
LIGHTS2 = ([[50.0, 60.0, 85.0], [30.0, 50.0, 120.0]],
           [[2500.0] * 3, [1000.0, 2000.0, 2000.0]])


def _round_matches_jax(light_pos, light_color, n_photons, seed):
    js = jscenes.full(atlas_res=32).replace(bezier_compact_frac=0.05)
    lp, lc = jnp.asarray(light_pos, jnp.float32), jnp.asarray(light_color, jnp.float32)
    key = jax.random.key(seed)
    with jax_walk_steps() as steps:
        dep_j, st_j, em_j = jax.jit(lambda k: jphoton.photon_trace_regen(
            js, k, lp, lc, n_photons, None, SEGS - 1,
            newton_fn=make_newton_pallas(interpret=True)))(key)
        jax.block_until_ready(dep_j)
    assert len(steps["photon"]) == SEGS

    ps = port_scene(js)
    draws = ReplayDraws(regen_round_draws(key, lp.shape[0] * n_photons, SEGS))
    with pinned_segments(photon_steps=steps["photon"]) as report:
        dep_p, st_p, em_p = photon.photon_trace_regen(
            ps, draws, torch.as_tensor(np.array(lp)), torch.as_tensor(np.array(lc)),
            n_photons, None, SEGS - 1, newton_fn=make_newton())
    print(report)
    assert draws.remaining == 0
    assert report.segments["photon"] == SEGS
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    for f in ("pos", "n", "flux", "valid"):
        np.testing.assert_array_equal(getattr(dep_p, f).numpy(),
                                      np.asarray(getattr(dep_j, f)), err_msg=f)
    for i, (got, want) in enumerate(zip(st_p, st_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(i))
    np.testing.assert_array_equal(em_p.numpy(), np.asarray(em_j))
    assert float(em_p.sum()) > lp.shape[0] * n_photons
    assert int(dep_p.valid.sum()) > 4 * n_photons
    return report


def test_regen_round_matches_jax_with_replayed_draws():
    js = jscenes.full(atlas_res=32)
    _round_matches_jax(js.light_pos, js.light_color, N, seed=7)


def test_two_light_round_matches_jax_with_replayed_draws():
    """The round-robin refill of two lights, held the same way."""
    _round_matches_jax(*LIGHTS2, n_photons=512, seed=3)


def test_two_lights_round_robin_balanced():
    """Per-light emitted counts stay within one photon (photon.py:145-155),
    on the port's own generator draws."""
    ps = port_scene(jscenes.full(atlas_res=16).replace(bezier_compact_frac=0.05))
    lp, lc = torch.tensor(LIGHTS2[0]), torch.tensor(LIGHTS2[1])
    gen = torch.Generator().manual_seed(0)
    st, total = None, torch.zeros(2)
    for _ in range(3):
        _, st, e = photon.photon_trace_regen(ps, gen, lp, lc, 256, st, 6)
        total += e
    assert total.sum() > 3 * 2 * 256
    assert abs(float(total[0] - total[1])) <= 1.0


def test_regen_state_init_matches_jax():
    for got, want in zip(photon.regen_state_init(2, 5), jphoton.regen_state_init(2, 5)):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_emit_photons_matches_jax():
    """Two lights, JAX's uniforms replayed: origins and fluxes exactly,
    directions to 1e-6 (sin and cos of another library)."""
    lp, lc = (jnp.asarray(x, jnp.float32) for x in LIGHTS2)
    key = jax.random.key(5)
    want = jlight.emit_photons(jax.random.split(key)[0], lp, lc, 300)
    draws = ReplayDraws(static_round_draws(key, 2, 300, 0))
    got = light.emit_photons(draws, torch.tensor(LIGHTS2[0]), torch.tensor(LIGHTS2[1]), 300)
    assert draws.remaining == 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)


def test_static_round_matches_jax_with_replayed_draws():
    """The static walk (photon.py:49-119), held segment by segment; the
    round's deposits then equal JAX's exactly."""
    js = jscenes.full(atlas_res=32).replace(bezier_compact_frac=0.05)
    key = jax.random.key(11)

    def jround(k):
        k_e, k_t = jax.random.split(k)
        o, d, f = jlight.emit_photons(k_e, js.light_pos, js.light_color, N)
        return jphoton.photon_trace(js, k_t, o, d, f, SEGS - 1,
                                    newton_fn=make_newton_pallas(interpret=True))

    with jax_walk_steps() as steps:
        dep_j = jax.jit(jround)(key)
        jax.block_until_ready(dep_j)
    assert len(steps["static"]) == SEGS
    ps = port_scene(js)
    draws = ReplayDraws(static_round_draws(key, 1, N, SEGS))
    with pinned_segments(static_steps=steps["static"]) as report:
        o, d, f = light.emit_photons(draws, ps.light_pos, ps.light_color, N)
        dep_p = photon.photon_trace(ps, draws, o, d, f, SEGS - 1, newton_fn=make_newton())
    print(report)
    assert draws.remaining == 0
    assert report.segments["static"] == SEGS
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    for fld in ("pos", "n", "flux", "valid"):
        np.testing.assert_array_equal(getattr(dep_p, fld).numpy(),
                                      np.asarray(getattr(dep_j, fld)), err_msg=fld)
    assert int(dep_p.valid.sum()) > 2 * N
