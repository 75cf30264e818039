"""The Epanechnikov deposit: the port's ``deposit_bruteforce(kernel=
"epanechnikov")`` / ``deposit_bruteforce_epa`` against the JAX package's
(raytrace3_tpu/render/deposit.py:68-151) on tests/test_deposit.py's
inputs, its autograd gradients against ``jax.grad`` and against central
differences (tests/test_deposit.py:524), and a train step with it against
JAX's loss and gradients (``scripts/inverse_ctrl_anneal.py``'s use).

Tolerances: counts are sums of 0/1 and must be equal; the flux agrees to
rtol 1e-5 (one chunk's matmul, positive terms summed in another order);
gradients to 1e-4 of each argument's largest (the same sums, transposed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_walk_steps, port_records, random_case, static_rounds_draws, wall_case
from raytrace3_tpu.core.types import Deposits as JDeposits
from raytrace3_tpu.core.types import make_hitpoints as j_make_hitpoints
from raytrace3_tpu.diff import train as jtrain
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import deposit as jdeposit
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.utils.config import RenderConfig as JaxConfig

from raytrace3_tpu_torch.convert import params_from_numpy
from raytrace3_tpu_torch.core.sampling import ReplayDraws
from raytrace3_tpu_torch.diff import train
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import driver
from raytrace3_tpu_torch.render.deposit import deposit_bruteforce, deposit_bruteforce_epa
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments
from raytrace3_tpu_torch.utils.config import RenderConfig

FLUX_RTOL = 1e-5
GRAD_ATOL = 1e-4


def _dense_case(rng):
    """tests/test_deposit.py:534-539: 60 hit points and 200 deposits in a
    10^3 box, so that the gradients have real support."""
    hp, dep = random_case(rng, C=60, D=200)
    return hp.replace(pos=hp.pos / 4.0), dep.replace(pos=dep.pos / 4.0)


@pytest.mark.parametrize("case", ["uniform", "wall", "dense"])
def test_epa_forward_matches_jax(rng, case):
    hp, dep = {"uniform": random_case, "wall": wall_case, "dense": _dense_case}[case](rng)
    want_cnt, want_tao = jdeposit.deposit_bruteforce_epa(hp, dep, chunk=512)
    cnt, tao = deposit_bruteforce_epa(*port_records(hp, dep), chunk=512)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_allclose(tao.numpy(), np.asarray(want_tao), rtol=FLUX_RTOL, atol=0)
    assert float(np.asarray(want_tao).max()) > 0
    # The count stays box-counted; the flux weights differ from the box's.
    box_cnt, box_tao = deposit_bruteforce(*port_records(hp, dep), chunk=512)
    np.testing.assert_array_equal(box_cnt.numpy(), cnt.numpy())
    assert not torch.equal(box_tao, tao)


def _weights(shape):
    return 0.5 + 0.01 * np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


def _port_loss(php, pdep, dpos, hpos, r2):
    _, tao = deposit_bruteforce_epa(php.replace(pos=hpos, r2=r2), pdep.replace(pos=dpos),
                                    chunk=128)
    return (tao * torch.as_tensor(_weights(tao.shape))).sum()


def _jax_loss(hp, dep):
    def loss(dpos, hpos, r2):
        _, tao = jdeposit.deposit_bruteforce_epa(hp.replace(pos=hpos, r2=r2),
                                                 dep.replace(pos=dpos), chunk=128)
        return jnp.sum(tao * jnp.asarray(_weights(tao.shape)))
    return loss


def test_epa_gradients_match_jax(rng):
    """``torch.autograd.grad`` through the checkpointed chunks against
    ``jax.grad`` w.r.t. deposit positions, hit positions and r2."""
    hp, dep = _dense_case(rng)
    want = jax.jit(jax.grad(_jax_loss(hp, dep), argnums=(0, 1, 2)))(dep.pos, hp.pos, hp.r2)
    php, pdep = port_records(hp, dep)
    args = [x.clone().requires_grad_(True) for x in (pdep.pos, php.pos, php.r2)]
    got = torch.autograd.grad(_port_loss(php, pdep, *args), args)
    for name, g, w in zip(("dpos", "hpos", "r2"), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=name)


def test_epa_gradients_match_fd(rng):
    """tests/test_deposit.py:524-596 on the port: the weight 2 (1 - d2/r2)
    is continuous at the radius, so autograd's gradients w.r.t. deposit
    positions, hit positions and r2 match central differences (8% + 1e-3);
    and over a dense uniform disc of deposits the kernel's flux sum equals
    the box's to 5% (both estimate the same density)."""
    hp, dep = _dense_case(rng)
    php, pdep = port_records(hp, dep)
    base = [pdep.pos, php.pos, php.r2]
    args = [x.clone().requires_grad_(True) for x in base]
    grads = torch.autograd.grad(_port_loss(php, pdep, *args), args)
    eps = 3e-3
    rng2 = np.random.default_rng(1)
    checked = 0
    for i, name in enumerate(("dpos", "hpos", "r2")):
        ga = grads[i].numpy()
        nz = np.flatnonzero(np.abs(ga).ravel() > 1e-4)
        for flat in rng2.choice(nz, size=min(6, nz.size), replace=False):
            idx = np.unravel_index(int(flat), ga.shape)

            def at(v):
                moved = [x.clone() for x in base]
                moved[i][idx] = v
                with torch.no_grad():
                    return float(_port_loss(php, pdep, *moved))
            a = float(base[i][idx])
            fd = (at(a + eps) - at(a - eps)) / (2 * eps)
            ad = float(ga[idx])
            assert abs(fd - ad) <= 0.08 * max(abs(fd), abs(ad)) + 1e-3, (name, idx, fd, ad)
            checked += 1
    assert checked >= 10, checked

    C1 = j_make_hitpoints(1, init_r2=2.0)
    C1 = C1.replace(pos=jnp.zeros((1, 3)), n=jnp.asarray([[0.0, 1.0, 0.0]]),
                    wgt=jnp.ones((1, 3)), valid=jnp.ones((1,), bool))
    M = 60000
    xy = rng.uniform(-1.5, 1.5, size=(M, 2)).astype(np.float32)
    dd = JDeposits(pos=jnp.asarray(np.stack([xy[:, 0], np.zeros(M, np.float32), xy[:, 1]], 1)),
                   n=jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (M, 3)),
                   flux=jnp.ones((M, 3)), valid=jnp.ones((M,), bool))
    p1, pd = port_records(C1, dd)
    _, tao_box = deposit_bruteforce(p1, pd)
    _, tao_epa = deposit_bruteforce_epa(p1, pd)
    ratio = float(tao_epa[0, 0] / tao_box[0, 0])
    assert abs(ratio - 1.0) < 0.05, ratio


#: tests/test_torch_train.py's small ``full`` slice: 16 x 16, 2 x 256
#: photons, the camera and the light on the teapot, the Newton kernel
#: contract; gradients per parameter within SLICE_GRAD_ATOL of its largest,
#: as there.
SMALL = dict(scene="full", width=16, height=16, rounds=2, photons_per_round=256,
             max_depth=13, atlas_res=16, bezier_compact_frac=0.5, hitpoint_factor=1.5)
POSE = ((30.0, 20.0, 170.0), (20.0, 5.0, 120.0))
LIGHT = [[35.0, 15.0, 125.0]]
SEGS = 14
SLICE_GRAD_ATOL = 2e-3


def test_epa_train_step_matches_jax():
    """``make_train_step(deposit_fn=deposit_bruteforce_epa)``: one step's
    loss and its gradients w.r.t. the control points (and the albedos)
    against ``jax.value_and_grad`` of JAX's loss with its Epanechnikov
    deposit, the walks held to JAX's segment by segment."""
    cfg = RenderConfig(**SMALL)
    key = jax.random.key(4)
    target = np.random.default_rng(3).uniform(0, 1, (16, 16, 3)).astype(np.float32)

    jscene = jdriver.build_scene(JaxConfig(**SMALL)).replace(
        light_pos=jnp.asarray(LIGHT, jnp.float32))
    render = jtrain.make_render_fn(
        jscene, JaxConfig(**SMALL), POSE,
        make_newton_pallas(iters=10, restarts=8, interpret=True),
        jdeposit.deposit_bruteforce_epa)
    j_params = jtrain.extract_params(jscene)

    def loss(p):
        return jnp.mean((render(p, key) - jnp.asarray(target).reshape(-1, 3)) ** 2)

    with jax_walk_steps() as steps:
        j_val, j_grads = jax.jit(jax.value_and_grad(loss))(j_params)
        jax.block_until_ready(j_grads)

    scene = driver.build_scene(cfg, device="cpu").replace(
        light_pos=torch.tensor(LIGHT, dtype=torch.float32))
    init_fn, step_fn = train.make_train_step(scene, cfg, train.adam(1e-2), POSE,
                                             make_newton(10, 8), deposit_bruteforce_epa)
    params = params_from_numpy({k: np.asarray(v) for k, v in j_params.items()})
    opt = init_fn(params)
    draws = ReplayDraws(static_rounds_draws(key, cfg.rounds, 1, cfg.photons_per_round, SEGS))
    with pinned_segments(eye_steps=steps["eye"], static_steps=steps["static"]) as report:
        _, _, val, stats = step_fn(params, opt, draws, torch.as_tensor(target))
    print(report)
    assert draws.remaining == 0
    assert report.segments == {"eye": SEGS, "photon": 0, "static": cfg.rounds * SEGS}
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    assert int(stats["deposits_dropped"]) == 0
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-5)
    for k in ("ctrl", "diff"):
        g, w = params[k].grad.numpy(), np.asarray(j_grads[k])
        err = np.abs(g - w).max() / np.abs(w).max()
        print(f"{k}: max |grad| {np.abs(w).max():.3g}, max |d grad| / max |grad| {err:.3g}")
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g, w, rtol=0, atol=SLICE_GRAD_ATOL * np.abs(w).max(),
                                   err_msg=k)
