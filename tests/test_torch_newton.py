"""Newton kernel: the plain twin vs the Pallas kernel (interpret mode, the
way tests/test_pallas.py runs it).  The CUDA kernel is held against the
plain twin on the card in tests/test_torch_cuda.py.

Both sides implement one contract with the same operation order, so the
hit decisions and patch ids agree exactly.  XLA's CPU code contracts each
multiply into the add that consumes it, and the twin rounds those
multiply-adds once as it does (``fma32``), so most roots are bit-equal; a
few are not, because which products XLA may contract depends on how it
fused the program it compiled, and ten steps carry a last-bit difference
on.  Roots t agree to 2e-6 relative (~16 ulp; seen: 4.6e-7 at t ~ 115)
and u, v to 2e-5 (seen: 3.8e-6).
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


def _order_free_winner(best_t, best_u, best_v, patch, restarts, order):
    """csrc/newton.cu's combine, written out: every accepted lane (t < BIG)
    is a state (t, g, u, v, p), g = p // (128 // restarts) its group; a
    smaller t wins, on equal t the smaller g, on equal (t, g) the minimum of
    u, of v and of p, each on its own.  Lanes are folded in ``order``."""
    R = best_t.shape[0]
    per_group = newton_kernel.LANES // restarts
    inf = torch.full((R,), float("inf"))
    t, g, u, v, p = inf.clone(), inf.clone(), inf.clone(), inf.clone(), inf.clone()
    for lane in order.tolist():
        lt, lu, lv = best_t[:, lane], best_u[:, lane], best_v[:, lane]
        lp = float(patch[lane])
        lg = float(int(patch[lane]) // per_group)
        acc = lt < newton_kernel.BIG
        wins = acc & ((lt < t) | ((lt == t) & (lg < g)))
        tie = acc & (lt == t) & (lg == g)
        u = torch.where(wins, lu, torch.where(tie, torch.minimum(u, lu), u))
        v = torch.where(wins, lv, torch.where(tie, torch.minimum(v, lv), v))
        p = torch.where(wins, lp, torch.where(tie, torch.minimum(p, torch.tensor(lp)), p))
        t = torch.where(wins, lt, t)
        g = torch.where(wins, lg, g)
    none = torch.isinf(t)
    big = torch.full_like(t, newton_kernel.BIG)
    return (torch.where(none, big, t), torch.where(none, 0.0, u), torch.where(none, 0.0, v),
            torch.where(none, 0.0, p))


@pytest.mark.parametrize("restarts", [8, 128])
def test_order_free_combine_equals_the_fold(restarts):
    """The kernel's order-free combine equals the twin's sequential fold on
    lane tables with exact t ties inside a group, across groups and at BIG
    (lanes that accepted nothing), the tied lanes' u and v differing; in
    any lane order."""
    rng = np.random.default_rng(restarts)
    R, n_groups = 48, 3
    n_lanes = n_groups * newton_kernel.LANES
    patch = torch.arange(n_lanes) // restarts
    big = newton_kernel.BIG
    best_t = torch.as_tensor(rng.choice(np.float32([1.5, 2.0, 2.75, big]), (R, n_lanes),
                                        p=[0.01, 0.01, 0.02, 0.96]))
    best_t[0] = big                                   # no lane accepted
    best_t[1, :] = big
    best_t[1, [5, 200, 300]] = 2.0                    # one t in three groups
    best_t[2, :] = big
    best_t[2, [3, 4, 9, 40]] = 1.5                    # tied inside group 0
    accepted = best_t < big
    best_u = torch.where(accepted, torch.as_tensor(
        rng.choice(np.float32([0.0, 0.125, 0.5, 1.0]), (R, n_lanes))), 0.0)
    best_v = torch.where(accepted, torch.as_tensor(
        rng.choice(np.float32([0.0, 0.25, 0.75, 1.0]), (R, n_lanes))), 0.0)
    want = newton_kernel.fold_winner(best_t, best_u, best_v, patch)
    tied = [int(((best_t[r] == want[0][r]) & accepted[r]).sum()) for r in range(R)]
    assert max(tied) > 1 and want[0][0] == big
    for seed in (0, 1):
        order = torch.as_tensor(np.random.default_rng(seed).permutation(n_lanes))
        got = _order_free_winner(best_t, best_u, best_v, patch, restarts, order)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_newton_constants_match_the_source():
    """The wrapper's copies of csrc/newton.cu's constants are the source's."""
    import re
    from pathlib import Path

    src = (Path(newton_kernel.__file__).parent.parent / "csrc" / "newton.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kThreads"), const("kRaysPerBlock"), const("kQueue"),
            const("kMaxPatches"), const("kGroupLanes")) == (
        newton_kernel.THREADS, newton_kernel.RAYS_PER_BLOCK, newton_kernel.QUEUE,
        newton_kernel.MAX_PATCHES, newton_kernel.LANES)


def test_drain_schedule_counts_the_kernels_work():
    """A block whose rays open every box drains a full queue at a time; a
    block that opens none runs no Newton; a partial last block counts."""
    rpb = newton_kernel.RAYS_PER_BLOCK
    R, B = rpb + 5, newton_kernel.MAX_PATCHES
    mask = torch.zeros((R, B), dtype=torch.bool)
    mask[:rpb] = True
    mask[rpb + 2, 7] = True
    s = newton_kernel.drain_schedule(mask, restarts=8)
    full = rpb * B // newton_kernel.QUEUE                 # drains of a full queue
    per_step = newton_kernel.THREADS // 8
    assert s["blocks"] == 2 and s["blocks_without_newton"] == 0
    assert s["drains"] == full + 1
    assert s["steps"] == full * newton_kernel.QUEUE // per_step + 1
    s = newton_kernel.drain_schedule(torch.zeros((3 * rpb, 4), dtype=torch.bool), 8)
    assert (s["blocks"], s["blocks_without_newton"], s["drains"], s["steps"]) == (3, 3, 0, 0)


def test_open_pairs_is_the_twins_gate():
    """``open_pairs`` is the gate ``solve_plain`` applies to every lane of a
    patch: a ray whose pairs are all closed has no hit."""
    org, d, ctrl = _teapot_rays(64, seed=3, scale=30.0)
    gate = newton_kernel.open_pairs(_t(org), _t(d), _t(ctrl))
    assert gate.shape == (64, 32) and 0 < int(gate.sum()) < gate.numel()
    hit = solve_plain(_t(org), _t(d), _t(ctrl), restarts=8)[4]
    assert not bool((hit & ~gate.any(1)).any())


def test_fma32_rounds_once_as_xla_contracts():
    """``fma32`` equals XLA's CPU code for ``a * b + c`` (contracted into one
    fused multiply-add) bit for bit, on random triples and on triples whose
    float64 sum lands on a float32 midpoint that the exact sum is not on,
    where rounding the float64 sum again would go the wrong way."""
    import jax

    rng = np.random.default_rng(7)
    n = 1 << 15
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    # a b within float64's rounding of 2^-24 and c in [1, 2): p + c lies a
    # hair off the midpoint c + 2^-24 and the float64 sum lands on it
    a_mid = rng.uniform(1.0, 2.0, n).astype(np.float32)
    b_mid = (2.0 ** -24 / a_mid.astype(np.float64)).astype(np.float32)
    c_mid = rng.uniform(1.0, 2.0, n).astype(np.float32)
    a2, b2, c = (np.concatenate(x) for x in ((a, a_mid), (b, b_mid), (c, c_mid)))
    s64 = a2.astype(np.float64) * b2 + c
    r32 = s64.astype(np.float32).astype(np.float64)
    halfway = np.abs(s64 - r32) == np.spacing(np.float32(r32)).astype(np.float64) / 2
    assert halfway[n:].sum() > 100                    # the hard cases occur
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a2, b2, c))
    got = newton_kernel.fma32(_t(a2), _t(b2), _t(c)).numpy()
    np.testing.assert_array_equal(got, want)
    naive = s64.astype(np.float32)
    assert (naive != want).sum() > 0                   # one float64 sum would not do


def test_edge_ray_agrees_to_the_solves_acceptance():
    """ROADMAP section 3, F2: pixel 51 of ``full`` at 16 x 16 meets patch 3
    at u = 0.999, where the Newton iterate is only good to the acceptance
    radius sqrt(M_EPS).  The port's root and JAX's share the hit, the patch,
    t to 2e-5 relative and u, v to 2e-5: the twin rounds the iterate as
    XLA's CPU code does, so it rejects the short iterate of step 10 that it
    took while it rounded every product (t 121.956741, v 0.25201011)."""
    from raytrace3_tpu import scenes as jscenes
    from raytrace3_tpu.render.camera import emit_rays as j_emit_rays

    org, d = (np.asarray(x)[51:52] for x in j_emit_rays(jscenes.reference_camera(16, 16)))
    ctrl = np.asarray(jscenes.full(atlas_res=8).bezier.ctrl)
    want = [np.asarray(x) for x in make_newton_pallas(interpret=True)(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(ctrl))]
    got = [x.numpy() for x in make_newton(restarts=8)(_t(org), _t(d), _t(ctrl))]
    print("jax t, u, v", [float(x[0]) for x in want[:3]],
          "port", [float(x[0]) for x in got[:3]])
    assert bool(want[4][0]) and bool(got[4][0]) and int(got[3][0]) == int(want[3][0]) == 3
    assert abs(float(got[0][0]) - float(want[0][0])) <= 2e-5 * float(want[0][0])
    assert float(want[1][0]) > 0.999
    for k in (1, 2):
        assert abs(float(got[k][0]) - float(want[k][0])) <= 2e-5
