"""The differentiable slice's modules against the JAX package's (the
whole train step is tests/test_torch_train.py):

* ``ops/solve3.solve3_columns`` elementwise;
* ``geometry/bezier.winner_root``'s implicit-function-theorem backward
  against ``jax.vjp`` of JAX's ``winner_root`` with the Pallas Newton
  kernel in interpret mode, on teapot rays, same cotangents;
* ``diff/vjp.deposit_bruteforce_vjp`` forward and gradients;
* ``diff/train``: the Adam step against ``optax.adam``, the parameters
  carried over from the JAX package, the deposit backend's selection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import port_records, random_case
from raytrace3_tpu.diff.vjp import deposit_bruteforce_vjp as j_bruteforce_vjp
from raytrace3_tpu.diff import train as jtrain
from raytrace3_tpu.geometry import bezier as jbez
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.ops.solve3 import solve3_columns as j_solve3
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.scenes import _teapot_ctrl
from raytrace3_tpu.utils.config import RenderConfig as JaxConfig

from raytrace3_tpu_torch.convert import params_from_numpy
from raytrace3_tpu_torch.diff import train
from raytrace3_tpu_torch.diff.vjp import deposit_bruteforce_vjp
from raytrace3_tpu_torch.geometry import bezier
from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.ops.solve3 import solve3_columns
from raytrace3_tpu_torch.render import driver
from raytrace3_tpu_torch.utils.config import RenderConfig

def _t(x):
    return torch.as_tensor(np.array(x))


def test_solve3_columns_matches_jax(rng):
    c0, c1, c2, r = (rng.normal(size=(500, 3)).astype(np.float32) for _ in range(4))
    c2[:5] = c1[:5] * 2.0                                  # singular lanes
    want = j_solve3(*map(jnp.asarray, (c0, c1, c2, r)))
    got = solve3_columns(*map(_t, (c0, c1, c2, r)))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert not got[3][:5].any()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_winner_root_backward_matches_jax():
    """The IFT backward against ``jax.vjp`` of JAX's ``winner_root`` on the
    Pallas kernel (interpret), same cotangents.  Hits and patch ids agree
    exactly; the roots differ by up to 4.6e-7 relative in t and 3.8e-6 in
    u, v (tests/test_torch_newton.py), which the 3 x 3 solve carries into
    the gradients: seen max |d grad| 1.4e-5 of the largest gradient, held
    to 1e-4 of it."""
    ctrl = np.asarray(_teapot_ctrl())
    rng = np.random.default_rng(1)
    n = 256
    org = np.tile(np.array([50.0, 35.0, 230.0], np.float32), (n, 1))
    d = ctrl.reshape(-1, 3).mean(0) + rng.normal(scale=14.0, size=(n, 3)) - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    g = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    solver = make_newton_pallas(interpret=True, restarts=8)
    out, vjp = jax.vjp(lambda o, dd, c: jbez.winner_root(o, dd, c, solver),
                       *map(jnp.asarray, (org, d, ctrl)))
    f0 = np.zeros(n, jax.dtypes.float0)
    want = vjp((*map(jnp.asarray, g), f0, f0))

    leaves = [_t(x).requires_grad_(True) for x in (org, d, ctrl)]
    got = bezier.winner_root(*leaves, make_newton())
    hit = got[4].numpy()
    np.testing.assert_array_equal(hit, np.asarray(out[4]))
    np.testing.assert_array_equal(got[3].numpy()[hit], np.asarray(out[3])[hit])
    assert hit.sum() > 20
    sum((x * _t(w)).sum() for x, w in zip(got[:3], g)).backward()
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        assert np.abs(w).max() > 0


def test_bruteforce_vjp_matches_jax(rng):
    """Forward and gradients of ``deposit_bruteforce_vjp`` (rtol 1e-5: the
    same products, summed in another order)."""
    hp, dep = random_case(rng, C=60, D=150)
    php, pdep = port_records(hp, dep)
    tgt = rng.normal(size=(60, 3)).astype(np.float32)

    def jax_loss(wgt, flux):
        cnt, tao = j_bruteforce_vjp(hp.replace(wgt=wgt), dep.replace(flux=flux), 64)
        return jnp.sum(jnp.sin(tao) * tgt), cnt

    (j_val, j_cnt), (j_gw, j_gf) = jax.value_and_grad(jax_loss, (0, 1), has_aux=True)(
        hp.wgt, dep.flux)
    wgt = php.wgt.clone().requires_grad_(True)
    flux = pdep.flux.clone().requires_grad_(True)
    cnt, tao = deposit_bruteforce_vjp(php.replace(wgt=wgt), pdep.replace(flux=flux), 64)
    loss = (torch.sin(tao) * _t(tgt)).sum()
    loss.backward()
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(wgt.grad.numpy(), np.asarray(j_gw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(flux.grad.numpy(), np.asarray(j_gf), rtol=1e-5, atol=1e-6)
    assert float(flux.grad.abs().max()) > 0




def test_adam_matches_optax(rng):
    """Two steps of ``train.adam`` on fixed gradients equal ``optax.adam``
    (bias correction on both steps) within 1e-6."""
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2)]
    opt = optax.adam(5e-2)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = _t(p0).requires_grad_(True)
    topt = train.adam(5e-2)([tp])
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = _t(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    assert np.abs(np.asarray(jp) - p0).max() > 0.05


def test_params_from_numpy_equal_the_ports_own():
    cfg = RenderConfig(scene="full", atlas_res=16)
    want = train.extract_params(driver.build_scene(cfg, device="cpu"))
    got = params_from_numpy({k: np.asarray(v) for k, v in
                             jtrain.extract_params(jdriver.build_scene(JaxConfig(**cfg.__dict__))).items()})
    assert sorted(got) == sorted(want) == ["atlas", "ctrl", "diff"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_default_deposit_vjp_selection():
    """The banded lane deposit with its kernel backward on the card at
    >= 256^2 (bounds from the scene), the bruteforce VJP elsewhere
    (tests/test_diff.py:236-255)."""
    big = RenderConfig(scene="full", width=512, height=512)
    small = RenderConfig(scene="full", width=128, height=128)
    scene = driver.build_scene(small.replace(atlas_res=16), device="cpu")
    dep = train.default_deposit_vjp(scene, big, device="cuda")
    assert isinstance(dep, DepositLane) and dep.differentiable
    assert (dep.tile, dep.chunk, dep.work_cap, dep.merge_z) == (256, 512, 16384, True)
    assert dep.x_lo < 1.0 and dep.x_lo + dep.n_bx * dep.bucket > 99.0
    assert train.default_deposit_vjp(scene, big, capacity=1 << 20, device="cuda").work_cap == 49152
    assert train.default_deposit_vjp(scene, small, device="cuda") is deposit_bruteforce_vjp
    assert train.default_deposit_vjp(scene, big) is deposit_bruteforce_vjp
