"""Port core vs the JAX package: vector math, compaction, table lookups,
types and samplers, elementwise on the same numpy inputs; the sampling law
tests of tests/test_sampling.py applied to the port's generator draws.

Tolerances: elementwise float32 math agrees to rtol 1e-6 / atol 1e-6 (both
sides round each operation in fp32; sums of three terms may associate
differently, a few ulp); transcendentals (cos, sin, acos) to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu.core import sampling as jsampling
from raytrace3_tpu.core import types as jtypes
from raytrace3_tpu.core import vecmath as jvm
from raytrace3_tpu.ops.compact import compact_indices as j_compact
from raytrace3_tpu.ops.onehot import pick_columns as j_pick
from raytrace3_tpu.ops.onehot import take_rows as j_take

from raytrace3_tpu_torch.core import sampling, types, vecmath as vm
from raytrace3_tpu_torch.ops.compact import compact_indices
from raytrace3_tpu_torch.ops.onehot import onehot_f32, pick_columns, take_rows

RTOL = ATOL = 1e-6


def _vecs(rng, n=257, unit=False):
    v = rng.normal(size=(n, 3)).astype(np.float32) * 5
    v[:3] = [[0, 0, 0], [0, 0, 2.5], [1e-6, 0, 0]]  # degenerate lanes
    if unit:
        v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        v[0] = [0, 0, 1]
    return v.astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


CASES = {
    "dot": lambda m, a, b: m.dot(a, b),
    "cross": lambda m, a, b: m.cross(a, b),
    "norm": lambda m, a, b: m.norm(a),
    "dist2": lambda m, a, b: m.dist2(a, b),
    "normalize": lambda m, a, b: m.normalize(a),
    "reflect": lambda m, a, b: m.reflect(a, b),
    "anormal": lambda m, a, b: m.anormal(a),
    "any_near_zero": lambda m, a, b: m.any_near_zero(a * 1e-4),
    "mean_power": lambda m, a, b: m.mean_power(a),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vecmath_elementwise(rng, name):
    a, b = _vecs(rng), _vecs(rng, unit=True)
    want = np.asarray(CASES[name](jvm, jnp.asarray(a), jnp.asarray(b)))
    got = CASES[name](vm, _t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_refract_and_frame(rng):
    d = _vecs(rng, unit=True)
    n = _vecs(rng, unit=True)
    eta = rng.uniform(0.5, 1.6, size=len(d)).astype(np.float32)
    want = np.asarray(jvm.refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(eta)))
    got = vm.refract(_t(d), _t(n), _t(eta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for w, g in zip(jvm.orthonormal_frame(jnp.asarray(n)),
                    vm.orthonormal_frame(_t(n))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_rotate(rng):
    v, axis = _vecs(rng), _vecs(rng, unit=True)
    ang = rng.uniform(-3, 3, size=len(v)).astype(np.float32)
    ang[:4] = 0.0
    want = np.asarray(jvm.rotate(jnp.asarray(v), jnp.asarray(axis), jnp.asarray(ang)))
    got = vm.rotate(_t(v), _t(axis), _t(ang)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("density,cap", [(0.0, 16), (0.3, 40), (0.3, 200),
                                         (0.9, 100), (1.0, 256)])
def test_compact_indices_contract(rng, density, cap):
    mask = rng.uniform(size=256) < density
    want = np.asarray(j_compact(jnp.asarray(mask), cap, fill=999))
    got = compact_indices(_t(mask), cap, fill=999)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        compact_indices(_t(mask), cap).numpy(),
        np.asarray(j_compact(jnp.asarray(mask), cap)))


def test_table_lookups(rng):
    tbl = rng.normal(size=(9, 13)).astype(np.float32)
    itbl = rng.integers(-5, 5, size=(9,)).astype(np.int32)
    idx = rng.integers(0, 9, size=300).astype(np.int32)
    np.testing.assert_array_equal(take_rows(_t(tbl), _t(idx)).numpy(),
                                  np.asarray(j_take(jnp.asarray(tbl), jnp.asarray(idx))))
    np.testing.assert_array_equal(take_rows(_t(itbl), _t(idx)).numpy(),
                                  np.asarray(j_take(jnp.asarray(itbl), jnp.asarray(idx))))
    arr = rng.normal(size=(300, 5)).astype(np.float32)
    col = rng.integers(0, 5, size=300).astype(np.int32)
    np.testing.assert_array_equal(pick_columns(_t(arr), _t(col)).numpy(),
                                  np.asarray(j_pick(jnp.asarray(arr), jnp.asarray(col))))
    np.testing.assert_array_equal(onehot_f32(_t(col), 5).numpy(),
                                  np.eye(5, dtype=np.float32)[col])


def test_types_match_jax(rng):
    mats = dict(diff=rng.uniform(0, 1, (9, 3)), refl=rng.uniform(0, 1, (9, 3)),
                refr=rng.uniform(0, 1, (9, 3)), refrn=rng.uniform(0, 2, 9),
                refln=np.ones(9))
    mats = {k: v.astype(np.float32) for k, v in mats.items()}
    mats["diff"][2] = [0.5, 0.0, 0.5]
    mats["refrn"][3] = 0.0
    jm = jtypes.Materials(**{k: jnp.asarray(v) for k, v in mats.items()})
    pm = types.Materials(**{k: _t(v) for k, v in mats.items()})
    for name in ("is_diff", "is_refl", "is_refr"):
        np.testing.assert_array_equal(getattr(pm, name)().numpy(),
                                      np.asarray(getattr(jm, name)()))
    for w, g in zip(jm.powers(), pm.powers()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    inside = rng.uniform(size=9) < 0.5
    np.testing.assert_allclose(
        types.eta_from_refrn(_t(mats["refrn"]), _t(inside)).numpy(),
        np.asarray(jtypes.eta_from_refrn(jnp.asarray(mats["refrn"]), jnp.asarray(inside))),
        rtol=RTOL)
    jh = jtypes.make_hitpoints(7, 2.0)
    ph = types.make_hitpoints(7, 2.0, "cpu")
    for f in ("pos", "n", "wgt", "pixel", "valid", "r2", "nphot", "tao"):
        a, b = getattr(ph, f).numpy(), np.asarray(getattr(jh, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


def test_samplers_match_jax_on_same_uniforms(rng, key):
    """Given JAX's own draws, the port's samplers return JAX's directions
    and branches."""
    import jax

    n = 4096
    ku, kv = jax.random.split(key)
    z = jax.random.uniform(ku, (n,), minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(kv, (n,), minval=0.0, maxval=jsampling.TWO_PI)
    want = np.asarray(jsampling.uniform_sphere(key, (n,)))
    got = sampling.uniform_sphere(_t(z), _t(phi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    nrm = _vecs(rng, n, unit=True)
    ku, kv = jax.random.split(key)
    u1, u2 = jax.random.uniform(ku, (n,)), jax.random.uniform(kv, (n,))
    want = np.asarray(jsampling.cosine_hemisphere(key, jnp.asarray(nrm)))
    got = sampling.cosine_hemisphere(_t(u1), _t(u2), _t(nrm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    p = rng.uniform(0, 1, size=(3, n)).astype(np.float32)
    p[:, :8] = 0.0
    u = jax.random.uniform(key, (n,))
    want = np.asarray(jsampling.roulette(key, *map(jnp.asarray, p)))
    got = sampling.roulette(_t(u), *map(_t, p)).numpy()
    np.testing.assert_array_equal(got, want)


def _gen_draws(seed=0):
    return sampling.GeneratorDraws(torch.Generator().manual_seed(seed))


def test_uniform_sphere_is_unit_and_uniform():
    dr = _gen_draws()
    d = sampling.uniform_sphere(dr.uniform((20000,), -1.0, 1.0),
                                dr.uniform((20000,), 0.0, sampling.TWO_PI)).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-5)
    p = stats.kstest(d[:, 2], stats.uniform(loc=-1, scale=2).cdf).pvalue
    assert p > 1e-3, p
    assert np.linalg.norm(d.mean(0)) < 0.02


def test_cosine_hemisphere_distribution():
    n = torch.tensor([0.3, -0.5, 0.81]).expand(20000, 3)
    n = n / n.norm(dim=-1, keepdim=True)
    dr = _gen_draws(1)
    d = sampling.cosine_hemisphere(dr.uniform((20000,)), dr.uniform((20000,)), n).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-4)
    c = np.sum(d * n.numpy(), -1)
    assert (c > -1e-6).all()
    p = stats.kstest(c, lambda x: np.clip(x, 0, 1) ** 2).pvalue
    assert p > 1e-3, p


def test_roulette_frequencies_and_degenerate():
    n = 20000
    b = sampling.roulette(_gen_draws(2).uniform((n,)), torch.full((n,), 0.6),
                          torch.full((n,), 0.3), torch.full((n,), 0.1)).numpy()
    np.testing.assert_allclose(np.bincount(b, minlength=3) / n, [0.6, 0.3, 0.1],
                               atol=0.02)
    z = torch.zeros(8)
    assert (sampling.roulette(_gen_draws(3).uniform((8,)), z, z, z) == 2).all()


def test_replay_draws_checks_shape():
    dr = sampling.ReplayDraws([np.zeros(4, np.float32), np.ones(3, np.float32)])
    assert dr.uniform((4,)).shape == (4,)
    with pytest.raises(ValueError):
        dr.uniform((4,))
    with pytest.raises(RuntimeError):
        dr.uniform((1,))
