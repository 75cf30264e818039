"""Lane deposit: the port's ``DepositLane`` (host side + the plain twins of
kernels #3 and #4) vs the JAX package's ``PallasDepositLane`` in interpret
mode and vs the port's bruteforce oracle, on the uniform and wall
distributions of tests/test_deposit.py, at the small bounds of its
``_lane_kw`` (tile 32, chunk 128).  The CUDA kernels are held against the
twins on the card in tests/test_torch_cuda.py.

Tolerances: counts are sums of 0/1 in fp32 and must be equal; flux sums
against JAX's lane deposit rtol 1e-5 (the same pairs, summed in another
order), against the bruteforce rtol 2e-4 / atol 1e-4 (tests/test_deposit.py:
a matmul's order); gradients rtol 1e-5 / atol 1e-6 (tests/test_deposit.py:
320-379).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import port_records, random_case, wall_case
from raytrace3_tpu.diff.vjp import deposit_bruteforce_vjp as j_bruteforce_vjp
from raytrace3_tpu.ops.deposit_pallas import PallasDepositLane

from raytrace3_tpu_torch.diff.vjp import deposit_bruteforce_vjp
from raytrace3_tpu_torch.ops import lane_kernel
from raytrace3_tpu_torch.ops.lane_kernel import (DepositLane, deposit_lane,
                                                 deposit_lane_bwd,
                                                 deposit_lane_bwd_plain,
                                                 deposit_lane_plain)
from raytrace3_tpu_torch.render.deposit import deposit_bruteforce

#: tests/test_deposit.py:253-256 without ``interpret``.
KW = dict(tile=32, chunk=128, x_lo=-8.0, x_hi=48.0, z_lo=-8.0, z_hi=170.0,
          y_lo=-8.0, y_hi=88.0)
MODES = {"merge": {}, "nomerge": {"merge_z": False}, "1d": {"bucket2d": False}}
CASES = {"uniform": lambda rng: random_case(rng, C=400, D=900), "wall": wall_case}


def _kw(mode, **extra):
    kw = dict(KW, **MODES[mode], **extra)
    if mode == "1d":
        kw.pop("z_lo"), kw.pop("z_hi")
    return kw


def _pair(mode="merge", **extra):
    kw = _kw(mode, **extra)
    return DepositLane(**kw), PallasDepositLane(interpret=True, **kw)


def _close_flux(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_forward_matches_pallas_and_bruteforce(rng, case, mode):
    hp, dep = CASES[case](rng)
    php, pdep = port_records(hp, dep)
    pd, jd = _pair(mode, work_cap=1024)
    cnt, tao, ovf = pd(php, pdep)
    j_cnt, j_tao, j_ovf = jax.jit(jd)(hp, dep)
    assert int(ovf) == int(j_ovf) == 0
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
    _close_flux(tao.numpy(), j_tao)
    bc, bt = deposit_bruteforce(php, pdep)
    np.testing.assert_array_equal(cnt.numpy(), bc.numpy())
    np.testing.assert_allclose(tao.numpy(), bt.numpy(), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lane_host_side_matches_pallas(rng, mode):
    """Windows, work items at both alignments and ``work_items`` equal the
    JAX host side's exactly."""
    hp, dep = wall_case(rng)
    php, pdep = port_records(hp, dep)
    pd, jd = _pair(mode, work_cap=2048)
    assert (pd.win_offs, pd.win_offs_lo, pd.win_offs_hi, pd.n_bz) == \
        (jd.win_offs, jd.win_offs_lo, jd.win_offs_hi, jd.n_bz)
    prep_p, prep_j = pd.prepare(php), jax.jit(jd.prepare)(hp)
    np.testing.assert_array_equal(prep_p.lo_keys.numpy(), np.asarray(prep_j.lo_keys))
    np.testing.assert_array_equal(prep_p.hi_keys.numpy(), np.asarray(prep_j.hi_keys))
    n_tiles = prep_p.packed.shape[0] // pd.tile
    dk_p, _, Dp = pd._dep_sorted(pdep, pd.chunk)
    dk_j = jax.jit(lambda d: jd._dep_sorted(d, jd.chunk)[0])(dep)
    sk_p, ek_p = pd._window_lanes(prep_p, dk_p, n_tiles)
    sk_j, ek_j = jax.jit(jd._window_lanes, static_argnums=2)(prep_j, dk_j, n_tiles)
    build_j = jax.jit(jd._build_items, static_argnums=(2, 3, 4, 5))
    np.testing.assert_array_equal(sk_p.numpy(), np.asarray(sk_j))
    np.testing.assert_array_equal(ek_p.numpy(), np.asarray(ek_j))
    for align, W in ((128, 2048), (pd.chunk, 2048 + 3 * n_tiles), (128, 40)):
        got = pd._build_items(sk_p, ek_p, n_tiles, W, Dp, align)
        want = build_j(sk_j, ek_j, n_tiles, W, Dp, align)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{align}/{W}/{i}")
    assert int(pd.work_items(php, pdep)) == int(jax.jit(jd.work_items)(hp, dep))


def test_lane_prepared_reuse(rng):
    """prepare() once + r2 shrinking across rounds == fresh calls."""
    hp, dep = random_case(rng, C=300, D=700)
    php, pdep = port_records(hp, dep)
    pd = DepositLane(work_cap=4096, **KW)
    prep = pd.prepare(php)
    for scale in (1.0, 0.7):
        h = php.replace(r2=php.r2 * scale)
        a, b = pd(h, pdep, prep=prep), pd(h, pdep)
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
        bc, bt = deposit_bruteforce(h, pdep)
        np.testing.assert_array_equal(a[0].numpy(), bc.numpy())
        np.testing.assert_allclose(a[1].numpy(), bt.numpy(), rtol=2e-4, atol=1e-4)


def test_lane_overflow_and_empty(rng):
    """A tiny work cap: the same overflow as JAX's and the same partial sums
    (tiles straddling the cap summed in part, later tiles 0); empty and
    invalid inputs read 0."""
    hp, dep = wall_case(rng)
    php, pdep = port_records(hp, dep)
    pd = DepositLane(work_cap=1024, **KW)
    items = int(pd.work_items(php, pdep))
    assert 0 < items < 1024
    tiny_p, tiny_j = _pair(work_cap=max(items // 4, 1))
    cnt, tao, ovf = tiny_p(php, pdep)
    j_cnt, j_tao, j_ovf = jax.jit(tiny_j)(hp, dep)
    assert int(ovf) == int(j_ovf) > 0
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
    _close_flux(tao.numpy(), j_tao)
    assert torch.isfinite(tao).all() and 0 < float(cnt.sum()) < float(pd(php, pdep)[0].sum())
    c, t, o = pd(php, pdep.replace(valid=torch.zeros_like(pdep.valid)))
    assert float(c.abs().sum()) == 0.0 and float(t.abs().sum()) == 0.0 and int(o) == 0
    c, t, o = pd(php.replace(valid=torch.zeros_like(php.valid)), pdep)
    assert float(c.abs().sum()) == 0.0


def _vjp_losses(pd, jd, php, pdep, hp, dep, tgt):
    def port(fn):
        wgt = php.wgt.clone().requires_grad_(True)
        flux = pdep.flux.clone().requires_grad_(True)
        out = fn(php.replace(wgt=wgt), pdep.replace(flux=flux))
        loss = (out[1] * torch.as_tensor(tgt)).sum()
        loss.backward()
        return float(loss.detach()), wgt.grad.numpy(), flux.grad.numpy()

    def jax_loss(wgt, flux):
        _, tao, _ = jd(hp.replace(wgt=wgt), dep.replace(flux=flux))
        return jnp.sum(tao * tgt)

    j_val, (j_gw, j_gf) = jax.jit(jax.value_and_grad(jax_loss, (0, 1)))(hp.wgt, dep.flux)
    return port(pd), port(deposit_bruteforce_vjp), (float(j_val), j_gw, j_gf)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_vjp_matches_pallas_and_bruteforce(rng, case):
    """d_wgt and d_flux through DepositLane(differentiable=True), whose
    backward is kernel #4's twin, equal JAX's lane VJP and the port's
    bruteforce VJP."""
    hp, dep = CASES[case](rng)
    php, pdep = port_records(hp, dep)
    pd, jd = _pair(work_cap=1024, differentiable=True)
    tgt = np.random.default_rng(7).normal(size=(hp.capacity, 3)).astype(np.float32)
    lane, bf, ref = _vjp_losses(pd, jd, php, pdep, hp, dep, tgt)
    for other in (bf, ref):
        np.testing.assert_allclose(lane[0], other[0], rtol=1e-5)
        _close_flux(lane[1], other[1])
        _close_flux(lane[2], other[2])
    assert np.abs(lane[2]).max() > 0


def test_lane_vjp_under_prep_reuse(rng):
    """The photon_rounds pattern: prepare() outside, gradients through
    repeated calls with shrinking r2, equal to JAX's."""
    hp, dep = random_case(rng, C=200, D=500)
    php, pdep = port_records(hp, dep)
    pd, jd = _pair(work_cap=1024, differentiable=True)

    def jax_loss(wgt, flux):
        h = hp.replace(wgt=wgt)
        prep = jd.prepare(h)
        return sum(jnp.sum(jd(h.replace(r2=hp.r2 * s), dep.replace(flux=flux), prep=prep)[1])
                   for s in (1.0, 0.7))

    wgt = php.wgt.clone().requires_grad_(True)
    flux = pdep.flux.clone().requires_grad_(True)
    h = php.replace(wgt=wgt)
    prep = pd.prepare(h)
    sum(pd(h.replace(r2=php.r2 * s), pdep.replace(flux=flux), prep=prep)[1].sum()
        for s in (1.0, 0.7)).backward()
    j_gw, j_gf = jax.jit(jax.grad(jax_loss, (0, 1)))(hp.wgt, dep.flux)
    _close_flux(wgt.grad.numpy(), j_gw)
    _close_flux(flux.grad.numpy(), j_gf)
    assert float(flux.grad.abs().sum()) > 0


def _round_inputs(rng):
    hp, dep = wall_case(rng)
    php, pdep = port_records(hp, dep)
    pd = DepositLane(work_cap=1024, **KW)
    prep = pd.prepare(php)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(php.valid, php.r2, -1.0)
    return pd, prep, packed, pdep


def test_lane_twins_steps_and_transpose(rng):
    """The twins do not depend on their step size, the CPU wrappers launch
    nothing, and the backward twin is the forward's transpose:
    sum_i u_i . fl_i = sum_j d_flux_j . flux_j."""
    pd, prep, packed, pdep = _round_inputs(rng)
    n_tiles = packed.shape[0] // pd.tile
    dkeys, dep_packed, Dp = pd._dep_sorted(pdep, pd.chunk)
    sk, ek = pd._window_lanes(prep, dkeys, n_tiles)
    lo, hi, wa, wb, overflow = pd.forward_items(sk, ek, n_tiles, Dp)
    assert int(overflow) == 0
    before = (lane_kernel.FORWARD.launches, lane_kernel.BACKWARD.launches)
    out = deposit_lane(lo, hi, wa, wb, packed, dep_packed)
    np.testing.assert_array_equal(
        out.numpy(), deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed, 32 * 5).numpy())

    items = pd.backward_items(sk, ek, n_tiles, Dp)
    run_lo, run_hi, wt, wa, wb = items
    assert bool((wb[run_hi[-1]:] <= wa[run_hi[-1]:]).all())      # pads last
    assert bool(((wa[:run_hi[-1]] // pd.chunk) == torch.repeat_interleave(
        torch.arange(Dp // pd.chunk), (run_hi - run_lo).long())).all())
    u = torch.as_tensor(np.random.default_rng(3).normal(size=(packed.shape[0], 3)),
                        dtype=torch.float32)
    args = (*items, packed, u, dep_packed)
    d = deposit_lane_bwd(*args, pd.tile, pd.chunk)
    torch.testing.assert_close(d, deposit_lane_bwd_plain(*args, pd.tile, 32 * 3),
                               rtol=1e-5, atol=1e-5)
    assert (lane_kernel.FORWARD.launches, lane_kernel.BACKWARD.launches) == before
    lhs = float((u.double() * out[:, 1:4].double()).sum())
    rhs = float((d.T.double() * dep_packed[6:9].T.double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
    assert float(out[:, 0].sum()) > 20


def _cu_constants(name):
    src = (Path(lane_kernel.__file__).parent.parent / "csrc" / name).read_text()
    return {k: eval(v, {}) for k, v in re.findall(r"constexpr int (k\w+) = ([\d *]+);", src)}


def test_lane_bwd_geometry_constants_match_the_source():
    """The wrapper's copies of csrc/deposit_lane_bwd.cu's constants are the
    source's (the kernel refuses any other geometry at launch)."""
    consts = _cu_constants("deposit_lane_bwd.cu")
    want = {"kBwdMaxTile": lane_kernel.LANE_BWD_MAX_TILE,
            "kBwdMaxChunk": lane_kernel.LANE_BWD_MAX_CHUNK,
            "kBwdMaxThreads": lane_kernel.LANE_BWD_MAX_THREADS,
            "kBwdMaxItems": lane_kernel.LANE_BWD_MAX_ITEMS,
            "kBwdMaxSharedBytes": lane_kernel.LANE_BWD_MAX_SHARED_BYTES,
            "kBwdMaxGroups": lane_kernel.LANE_BWD_MAX_GROUPS}
    assert {k: consts.get(k) for k in want} == want
    assert 1 <= lane_kernel.LANE_BWD_ITEMS_PER_BLOCK <= lane_kernel.LANE_BWD_MAX_ITEMS


@pytest.mark.parametrize("tile", [1, 30, 32, 96, 256, 1000, 1024])
def test_lane_bwd_geometry_fits_every_chunk(tile):
    """Kernel #4's geometry for every chunk (1..1024): the chunk rounded up
    to a warp, and shared memory for the part's tiles (packed rows, u rows
    padded to float4s), three strides of partial sums (one a virtual
    thread: at most the block or the part's lanes) and the chunk's lanes,
    within an H100 block's opt-in limit."""
    k = lane_kernel.LANE_BWD_ITEMS_PER_BLOCK
    for chunk in range(1, 1025):
        g = lane_kernel.lane_bwd_geometry(tile, chunk)
        assert g.threads % 32 == 0 and chunk <= g.threads < chunk + 32
        assert g.items_per_block == k and g.partial_stride == max(g.threads, k * chunk)
        tiles = k * (tile * 8 + 4 * ((3 * tile + 3) // 4))
        assert g.shared_bytes == 4 * (tiles + 3 * g.partial_stride + 6 * chunk)
        assert g.shared_bytes <= lane_kernel.LANE_BWD_MAX_SHARED_BYTES
    for bad in [(0, 512), (1025, 512), (tile, 0), (tile, 1025)]:
        with pytest.raises(ValueError):
            lane_kernel.lane_bwd_geometry(*bad)


@pytest.mark.parametrize("tile", [1, 7, 30, 256, 1001])
def test_lane_bwd_thread_map_tests_every_pair_once(tile):
    """Kernel #4's map of a block's threads onto a part's items: their
    masked lanes laid end to end (L in all), G = max(1, min(T // L, tile,
    16)) groups, virtual threads v = t, t + T, ... below G L, v = g L + q
    testing lane q against rows g, g + G, ... of its item's tile.  Every
    (item, lane, row) is tested by exactly one virtual thread."""
    rng = np.random.default_rng(tile)
    for chunk in (32, 100, 512, 1024):
        g = lane_kernel.lane_bwd_geometry(tile, chunk)
        for _ in range(12):
            m = int(rng.integers(1, g.items_per_block + 1))
            n = [int(x) for x in rng.choice([0, 1, 2, 5, 31, 33, chunk // 3, chunk], m)
                 if x <= chunk]
            L = sum(n)
            G = g.groups(L)
            if L == 0:
                assert G == 0
                continue
            assert 1 <= G <= min(tile, lane_kernel.LANE_BWD_MAX_GROUPS)
            assert G * L <= max(g.threads, L) <= g.partial_stride
            seen = [np.zeros((ni, tile), np.int64) for ni in n]
            for v in range(G * L):
                grp, q = divmod(v, L)
                i = 0
                while q >= n[i]:
                    q -= n[i]
                    i += 1
                seen[i][q, grp::G] += 1
            assert all((x == 1).all() for x in seen), (chunk, n)


@pytest.mark.parametrize("per_block", [1, 2, 3, 4, 7])
def test_run_parts_cut_every_run_in_order(per_block):
    """run_parts: every run cut into max(1, ceil(n / per_block)) parts; the
    parts, in block order, take each run's items once and in order (as the
    kernels compute a part's items); spare blocks beyond the list's parts
    are marked with the run count."""
    rng = np.random.default_rng(per_block)
    n = rng.choice([0, 0, 1, 2, 3, 5, 9, 28], 40)
    hi = np.cumsum(n)
    lo = hi - n
    W = int(hi[-1]) + 11
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    part_run, part_end = lane_kernel.run_parts(i32(lo), i32(hi), per_block, W)
    assert part_run.dtype == part_end.dtype == torch.int32
    assert part_run.shape[0] == len(n) + -(-W // per_block)
    parts = np.maximum(1, -(-n // per_block))
    np.testing.assert_array_equal(part_end.numpy(), np.cumsum(parts))
    taken = {r: [] for r in range(len(n))}
    for j, r in enumerate(part_run.tolist()):
        if r == len(n):
            assert j >= int(part_end[-1])
            continue
        p = j - (int(part_end[r]) - parts[r])
        a = lo[r] + p * per_block
        taken[r] += list(range(a, min(a + per_block, hi[r])))
    for r in range(len(n)):
        assert taken[r] == list(range(lo[r], hi[r]))
    assert (part_run.numpy()[int(part_end[-1]):] == len(n)).all()


def test_lane_twins_sum_in_float64(rng):
    """Both lane twins with their sums taken in float64 (the witness the
    kernels are held to on the card): the same counts, and flux within
    float32 rounding of the float32 twins."""
    pd, prep, packed, pdep = _round_inputs(rng)
    n_tiles = packed.shape[0] // pd.tile
    dkeys, dep_packed, Dp = pd._dep_sorted(pdep, pd.chunk)
    sk, ek = pd._window_lanes(prep, dkeys, n_tiles)
    lo, hi, wa, wb, _ = pd.forward_items(sk, ek, n_tiles, Dp)
    a = deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed)
    b = deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed, sum_dtype=torch.float64)
    assert b.dtype == torch.float32 and float(a[:, 0].sum()) > 20
    np.testing.assert_array_equal(b[:, 0].numpy(), a[:, 0].numpy())
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
    items = pd.backward_items(sk, ek, n_tiles, Dp)
    u = torch.as_tensor(np.random.default_rng(4).uniform(size=(packed.shape[0], 3)),
                        dtype=torch.float32)
    args = (*items, packed, u, dep_packed, pd.tile)
    c = deposit_lane_bwd_plain(*args)
    d = deposit_lane_bwd_plain(*args, sum_dtype=torch.float64)
    assert d.dtype == torch.float32 and float(c.sum()) > 0
    np.testing.assert_allclose(d.numpy(), c.numpy(), rtol=1e-5, atol=1e-6)
