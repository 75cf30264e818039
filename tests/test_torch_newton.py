"""Newton kernel: the plain twin vs the Pallas kernel (interpret mode, the
way tests/test_pallas.py runs it).  The CUDA kernel is held against the
plain twin on the card in tests/test_torch_cuda.py.

Both sides implement one contract with the same operation order, so the
hit decisions and patch ids agree exactly.  The floats are not bit-equal:
XLA fuses the Newton step's multiply-adds, PyTorch on the CPU rounds each
product, and ten steps carry the difference on.  Roots t agree to 2e-6
relative (~16 ulp; seen: 4.6e-7 at t ~ 115) and u, v to 2e-5 (seen: 3.8e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu.ops.newton_pallas import _uv0_rows, make_newton_pallas
from raytrace3_tpu.scenes import _teapot_ctrl

from raytrace3_tpu_torch.ops import newton_kernel
from raytrace3_tpu_torch.ops.newton_kernel import make_newton, solve, solve_plain


def _flat_patch():
    g = np.linspace(0, 1, 4)
    uu, vv = np.meshgrid(g, g, indexing="xy")
    return np.stack([uu, vv, np.full_like(uu, 2.0)], -1)[None].astype(np.float32)


def _teapot_rays(n=96, seed=1, scale=14.0):
    """tests/test_pallas.py:50-58's rays: from the camera toward the teapot."""
    ctrl = np.asarray(_teapot_ctrl())
    rng = np.random.default_rng(seed)
    org = np.tile(np.array([50.0, 35.0, 230.0], np.float32), (n, 1))
    d = (ctrl.reshape(-1, 3).mean(0) + rng.normal(scale=scale, size=(n, 3)) - org)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32), ctrl


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("restarts", [8, 16])
def test_plain_matches_pallas_on_teapot(restarts):
    org, d, ctrl = _teapot_rays()
    jsolve = make_newton_pallas(interpret=True, tile_r=32, restarts=restarts)
    want = [np.asarray(x) for x in jsolve(jnp.asarray(org), jnp.asarray(d), jnp.asarray(ctrl))]
    got = [x.numpy() for x in solve_plain(_t(org), _t(d), _t(ctrl), restarts=restarts)]
    t_j, u_j, v_j, p_j, h_j = want
    t_p, u_p, v_p, p_p, h_p = got
    assert p_p.dtype == np.int32 and h_p.dtype == bool
    np.testing.assert_array_equal(h_p, h_j)
    assert h_p.sum() > 5
    np.testing.assert_allclose(t_p, t_j, rtol=2e-6, atol=0)
    np.testing.assert_allclose(u_p[h_p], u_j[h_p], rtol=0, atol=2e-5)
    np.testing.assert_allclose(v_p[h_p], v_j[h_p], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(p_p[h_p], p_j[h_p])
    np.testing.assert_array_equal(p_p[~h_p], 0)


@pytest.mark.parametrize("restarts", [8, 16])
def test_flat_patch_analytic(restarts):
    org = np.array([[0.3, 0.4, 0.0], [0.9, 0.1, 1.0], [2.0, 2.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 3, np.float32)
    t, u, v, pid, hit = solve(_t(org), _t(d), _t(_flat_patch()), restarts=restarts)
    assert hit.tolist() == [True, True, False]
    np.testing.assert_allclose(t[:2].numpy(), [2.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(u[:2].numpy(), [0.3, 0.9], atol=1e-3)
    np.testing.assert_allclose(v[:2].numpy(), [0.4, 0.1], atol=1e-3)


def test_patch_padding_to_group():
    """B=3 patches pad one group; padded lanes never win; same as Pallas."""
    ctrl = np.concatenate([_flat_patch(), _flat_patch() + [0, 0, 1.0],
                           _flat_patch() + [0, 0, 2.0]]).astype(np.float32)
    org = np.array([[0.5, 0.5, 0.0], [0.2, 0.7, 2.5]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    got = solve(_t(org), _t(d), _t(ctrl), restarts=16)
    want = make_newton_pallas(interpret=True, tile_r=8, restarts=16)(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(ctrl))
    assert got[4].tolist() == [True, True]
    np.testing.assert_allclose(got[0].numpy(), [2.0, 0.5], atol=1e-3)
    assert got[3].tolist() == [0, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("restarts", [1, 2, 4, 8, 16, 32])
def test_restart_grid_matches_pallas(restarts):
    u0, v0 = _uv0_rows(restarts)
    tab = newton_kernel.uv0_table(restarts)
    np.testing.assert_array_equal(np.tile(tab[:, 0], 128 // restarts), u0[0])
    np.testing.assert_array_equal(np.tile(tab[:, 1], 128 // restarts), v0[0])


def test_bad_restarts_raise():
    org, d, ctrl = _teapot_rays(4)
    with pytest.raises(ValueError):
        solve(_t(org), _t(d), _t(ctrl), restarts=6)


def test_cpu_tensors_take_the_plain_path():
    org, d, ctrl = _teapot_rays(16)
    before = newton_kernel.KERNEL.launches
    a = make_newton(restarts=8)(_t(org), _t(d), _t(ctrl))
    b = solve_plain(_t(org), _t(d), _t(ctrl), restarts=8)
    assert newton_kernel.KERNEL.launches == before
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
