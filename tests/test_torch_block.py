"""The remaining deposit backends against the JAX package's, on the CPU:
``DepositBlock`` (kernel #5's plain twin) against ``PallasDeposit``,
``DepositStream`` (kernel #6's) against ``PallasDepositStream``,
``DepositZTile`` against ``PallasDepositZTile`` (all three in interpret
mode), and the grid deposit against ``make_grid_deposit``; each also
against the port's bruteforce oracle.  Cases follow tests/test_deposit.py:
uniform, wall, 2-D banding, prepared reuse, empty and invalid, and a work
cap too small.  The CUDA kernels are held against the twins on the card in
tests/test_torch_cuda.py.

Tolerances: counts are sums of 0/1 in fp32 and must be equal; against the
JAX backends flux (d_tao) to rtol 1e-5 (the same pairs summed in another
order), against the bruteforce rtol 2e-4 / atol 1e-4 (a matmul's order,
tests/test_deposit.py); overflow counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import port_records, random_case, wall_case
from raytrace3_tpu.ops.deposit_pallas import (PallasDeposit, PallasDepositStream,
                                              PallasDepositZTile)
from raytrace3_tpu.ops.grid import make_grid_deposit as j_grid

from raytrace3_tpu_torch.ops import deposit_kernel, lane_kernel
from raytrace3_tpu_torch.ops.deposit_kernel import (DepositBlock, DepositTile,
                                                    DepositZTile, deposit_block,
                                                    deposit_block_plain)
from raytrace3_tpu_torch.ops.grid import make_grid_deposit
from raytrace3_tpu_torch.ops.lane_kernel import (DepositStream, deposit_stream,
                                                 deposit_stream_plain)
from raytrace3_tpu_torch.render.deposit import deposit_bruteforce

CASES = {"uniform": lambda rng: random_case(rng, C=400, D=900), "wall": wall_case}
#: tests/test_deposit.py:152-257's PallasDeposit settings per case.
BLOCK = {"uniform": dict(tile=64, wchunk=128, work_cap=512),
         "wall": dict(tile=32, wchunk=128, work_cap=2048),
         "2d": dict(tile=32, wchunk=128, work_cap=8192, bucket2d=True,
                    x_lo=-8.0, x_hi=12.0, z_lo=-8.0, z_hi=170.0)}
ZKW = dict(tile=32, chunk=128, x_lo=-8.0, x_hi=48.0, z_lo=-8.0, z_hi=170.0,
           y_lo=-8.0, y_hi=88.0)


def _check(got, want, rtol=1e-5, atol=1e-6):
    cnt, tao, ovf = (np.asarray(x) for x in got)
    w_cnt, w_tao, w_ovf = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(cnt, w_cnt)
    np.testing.assert_allclose(tao, w_tao, rtol=rtol, atol=atol)
    assert int(ovf) == int(w_ovf)


def _check_bruteforce(got, php, pdep):
    bc, bt = deposit_bruteforce(php, pdep)
    np.testing.assert_array_equal(got[0].numpy(), bc.numpy())
    np.testing.assert_allclose(got[1].numpy(), bt.numpy(), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["uniform", "wall", "2d"])
def test_block_matches_pallas_and_bruteforce(rng, case):
    hp, dep = CASES["uniform" if case == "2d" else case](rng)
    php, pdep = port_records(hp, dep)
    got = DepositBlock(**BLOCK[case])(php, pdep)
    want = jax.jit(PallasDeposit(interpret=True, **BLOCK[case]))(hp, dep)
    assert int(got[2]) == 0
    _check(got, want)
    _check_bruteforce(got, php, pdep)


def test_block_prepared_reuse_and_packed_call(rng):
    hp, dep = random_case(rng, C=300, D=700)
    php, pdep = port_records(hp, dep)
    pd = DepositBlock(tile=64, wchunk=128, work_cap=512)
    jd = PallasDeposit(tile=64, wchunk=128, work_cap=512, interpret=True)
    prep, jprep = pd.prepare(php), jd.prepare(hp)
    for scale in (1.0, 0.7):
        h, ph = hp.replace(r2=hp.r2 * scale), php.replace(r2=php.r2 * scale)
        got = pd(ph, pdep, prep=prep)
        _check(got, jd(h, dep, prep=jprep))
        _check_bruteforce(got, ph, pdep)
        fresh = pd(ph, pdep)
        np.testing.assert_array_equal(got[1].numpy(), fresh[1].numpy())
    # layout space: pack, call, unpack == the hit-point-order call
    r2_pad, wgt_pad = pd.pack_state(php, prep)
    cnt_p, fl_p, ovf = pd.packed_call(r2_pad, pdep, prep)
    cnt, fl = pd.unpack_state(prep, cnt_p, fl_p)
    want = pd(php, pdep, prep=prep)
    v = php.valid
    np.testing.assert_array_equal(torch.where(v, cnt, 0).numpy(), want[0].numpy())
    np.testing.assert_array_equal(torch.where(v[:, None], php.wgt * fl / np.pi, 0).numpy(),
                                  torch.where(v[:, None], want[1], 0).numpy())
    assert int(ovf) == int(want[2]) == 0


def test_block_empty_and_invalid(rng):
    hp, dep = random_case(rng, C=100, D=200)
    php, pdep = port_records(hp, dep)
    pd = DepositBlock(tile=32, wchunk=128, work_cap=512)
    cnt, tao, _ = pd(php, pdep.replace(valid=torch.zeros_like(pdep.valid)))
    assert float(cnt.abs().sum()) == 0.0 and float(tao.abs().sum()) == 0.0
    cnt, tao, _ = pd(php.replace(valid=torch.zeros_like(php.valid)), pdep)
    assert float(cnt.abs().sum()) == 0.0
    with pytest.raises(ValueError, match="work_cap"):
        DepositBlock(tile=32, wchunk=128, work_cap=4)(php, pdep)


def _layout_round(pd, php, pdep):
    prep = pd.prepare(php)
    r2_pad, _ = pd.pack_state(php, prep)
    packed = prep.packed.clone()
    packed[:, 6] = r2_pad
    dkeys, dep_packed, Dp = pd._dep_sorted(pdep, pd.wchunk)
    return prep, packed, dkeys, dep_packed, Dp


def test_block_overflow_under_a_small_cap(rng):
    """A cap that cuts one tile's items in two (tests/test_deposit.py:
    236-257 cuts at n_tiles + 1; blocks of 32 lanes give the tiles several
    items each, and 6000 deposits give a tile pairs to cut): the overflow
    is reported and equals JAX's, and so do the counts and flux; in layout
    space the tiles whose first item lies beyond the cap read 0, the
    straddling tile keeps the partial sums of its items below the cap, and
    every other tile its whole sums."""
    hp, dep = wall_case(rng, D=6000)
    php, pdep = port_records(hp, dep)
    big = DepositBlock(tile=32, wchunk=32, work_cap=8192)
    prep, packed, dkeys, dep_packed, Dp = _layout_round(big, php, pdep)
    n_tiles = packed.shape[0] // 32
    wt_f, blk_f, wcmp_f, ovf_f, _ = big.work_list(prep, dkeys, n_tiles, Dp)
    assert int(ovf_f) == 0
    whole = deposit_block(wt_f, blk_f, wcmp_f, packed, dep_packed, 32, 32).reshape(
        n_tiles, 32, 8)
    # A tile past n_tiles of several items whose first item alone takes
    # some but not all of the tile's pairs: the cap cuts after that item.
    per_tile = torch.bincount(wt_f.long()[wcmp_f > 0], minlength=n_tiles)
    first = torch.searchsorted(wt_f, torch.arange(n_tiles, dtype=torch.int32))
    cut = None
    for t in torch.nonzero((per_tile >= 2) & (first >= n_tiles)).flatten().tolist():
        f = int(first[t])
        part = deposit_block(wt_f[f:f + 1], blk_f[f:f + 1], wcmp_f[f:f + 1], packed,
                             dep_packed, 32, 32).reshape(n_tiles, 32, 8)[t, :, 0].sum()
        if 0 < float(part) < float(whole[t, :, 0].sum()):
            cut, W = t, f + 1
            break
    assert cut is not None

    kw = dict(tile=32, wchunk=32, work_cap=W)
    pd = DepositBlock(**kw)
    got = pd(php, pdep)
    want = jax.jit(PallasDeposit(interpret=True, **kw))(hp, dep)
    assert int(got[2]) > 0
    _check(got, want)

    wt, blk, wcmp, ovf, total = pd.work_list(prep, dkeys, n_tiles, Dp)
    assert int(ovf) == int(got[2]) == (int(total) - W) * 32 and int(wt[-1]) == cut
    out = deposit_block(wt, blk, wcmp, packed, dep_packed, 32, 32).reshape(n_tiles, 32, 8)
    tiles = torch.arange(n_tiles)
    assert float(out[tiles > cut].abs().sum()) == 0.0
    np.testing.assert_array_equal(out[tiles < cut].numpy(), whole[tiles < cut].numpy())
    one = deposit_block(wt[-1:], blk[-1:], wcmp[-1:], packed, dep_packed, 32, 32)
    np.testing.assert_array_equal(out[cut].numpy(), one.reshape(n_tiles, 32, 8)[cut].numpy())
    assert 0 < float(out[cut, :, 0].sum()) < float(whole[cut, :, 0].sum())


def test_block_wrapper_takes_the_plain_twin_on_cpu(rng):
    hp, dep = wall_case(rng)
    php, pdep = port_records(hp, dep)
    pd = DepositBlock(tile=32, wchunk=128, work_cap=2048)
    prep = pd.prepare(php)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(php.valid, php.r2, -1.0)
    n_tiles = packed.shape[0] // 32
    dkeys, dep_packed, Dp = pd._dep_sorted(pdep, 128)
    args = (*pd.work_list(prep, dkeys, n_tiles, Dp)[:3], packed, dep_packed, 32, 128)
    before = deposit_kernel.BLOCK_KERNEL.launches
    a = deposit_block(*args)
    b = deposit_block_plain(*args, pairs_per_step=32 * 5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(a[:, 0].sum()) > 0
    assert deposit_kernel.BLOCK_KERNEL.launches == before
    assert deposit_kernel.BLOCK_KERNEL._fn is None


STREAM_MODES = {"1d": dict(bucket2d=False), "merge": {}, "nomerge": dict(merge_z=False)}


@pytest.mark.parametrize("mode", sorted(STREAM_MODES))
def test_stream_matches_pallas_and_bruteforce(rng, mode):
    """tests/test_deposit.py:451-468."""
    hp, dep = random_case(rng, C=700, D=1500)
    php, pdep = port_records(hp, dep)
    kw = dict(tile=128, chunk=256, work_cap=4096, x_lo=-4.0, x_hi=44.0, z_lo=-4.0,
              z_hi=44.0, **STREAM_MODES[mode])
    got = DepositStream(**kw)(php, pdep)
    want = jax.jit(PallasDepositStream(interpret=True, **kw))(hp, dep)
    assert int(got[2]) == 0
    _check(got, want)
    _check_bruteforce(got, php, pdep)


def test_stream_overflow_and_items(rng):
    """A cap a quarter of the work: overflow equal to JAX's, counts and flux
    of the partial work equal; the stream items decode to the lane
    deposit's masks."""
    hp, dep = wall_case(rng)
    php, pdep = port_records(hp, dep)
    kw = dict(tile=32, chunk=128, x_lo=-8.0, x_hi=48.0, z_lo=-8.0, z_hi=170.0,
              y_lo=-8.0, y_hi=88.0)
    items = int(DepositStream(work_cap=8192, **kw).work_items(php, pdep))
    kw["work_cap"] = max(items // 4, 1)
    pd = DepositStream(**kw)
    got = pd(php, pdep)
    want = jax.jit(PallasDepositStream(interpret=True, **kw))(hp, dep)
    assert int(got[2]) > 0
    _check(got, want)
    prep = pd.prepare(php)
    n_tiles = pd._c_pad(hp.capacity) // 32
    dkeys, dep_packed, Dp = pd._dep_sorted(pdep, pd.chunk)
    sk, ek = pd._window_lanes(prep, dkeys, n_tiles)
    itf, itab, starts, ends, ovf = pd.stream_items(sk, ek, n_tiles, Dp)
    lo, hi, wa, wb, ovf_lane = pd.forward_items(sk, ek, n_tiles, Dp)
    assert int(ovf) == int(ovf_lane) == int(got[2])
    np.testing.assert_array_equal(starts.numpy(), lo.numpy())
    np.testing.assert_array_equal(ends.numpy(), hi.numpy())
    da, db = lane_kernel.stream_mask(itf, itab)
    n = int(ends.max())
    np.testing.assert_array_equal(da[:n].numpy(), wa[:n].numpy())
    np.testing.assert_array_equal(db[:n].numpy(), wb[:n].numpy())
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(php.valid, php.r2, -1.0)
    before = lane_kernel.STREAM.launches
    a = deposit_stream(itf, itab, starts, ends, packed, dep_packed)
    b = deposit_stream_plain(itf, itab, starts, ends, packed, dep_packed,
                             pairs_per_step=32 * 3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert lane_kernel.STREAM.launches == before and lane_kernel.STREAM._fn is None
    with pytest.raises(ValueError, match="16-bit"):
        DepositStream(chunk=1 << 15, **{k: v for k, v in kw.items() if k != "chunk"})


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("z_coarse", [4.0, 12.0, 40.0, 500.0])
def test_ztile_matches_pallas_and_bruteforce(rng, case, z_coarse):
    """tests/test_deposit.py:469-491; z_coarse 4 makes tiles span several
    coarse z buckets (the conservative multi-bucket window)."""
    hp, dep = CASES[case](rng)
    php, pdep = port_records(hp, dep)
    pd = DepositZTile(z_coarse=z_coarse, **ZKW)
    jd = PallasDepositZTile(z_coarse=z_coarse, interpret=True, **ZKW)
    got = pd(php, pdep)
    _check(got, jax.jit(jd)(hp, dep))
    _check_bruteforce(got, php, pdep)
    prep, jprep = pd.prepare(php), jd.prepare(hp)
    np.testing.assert_array_equal(prep.lo_keys.numpy(), np.asarray(jprep.lo_keys))
    np.testing.assert_array_equal(prep.hi_keys.numpy(), np.asarray(jprep.hi_keys))
    assert (pd.n_buckets, pd._sentinel_key(), len(pd.win_offs)) == \
        (jd.n_buckets, jd._sentinel_key(), 6)


def test_ztile_prep_reuse_and_packed(rng):
    """tests/test_deposit.py:494-522."""
    hp, dep = wall_case(rng, C=300, D=1200)
    php, pdep = port_records(hp, dep)
    pd = DepositZTile(z_coarse=12.0, **ZKW)
    prep = pd.prepare(php)
    for scale in (1.0, 0.6):
        ph = php.replace(r2=php.r2 * scale)
        _check_bruteforce(pd(ph, pdep, prep=prep), ph, pdep)
    r2_pad, _ = pd.pack_state(php, prep)
    cnt_p, fl_p, ovf = pd.packed_call(r2_pad, pdep, prep)
    assert int(ovf) == 0
    cnt, fl = pd.unpack_state(prep, cnt_p, fl_p)
    bc, bt = deposit_bruteforce(php, pdep)
    v = php.valid
    np.testing.assert_array_equal(torch.where(v, cnt, 0).numpy(), bc.numpy())
    np.testing.assert_allclose(torch.where(v[:, None], php.wgt * fl / np.pi, 0).numpy(),
                               bt.numpy(), rtol=2e-4, atol=1e-4)
    # and equal to the plain tile deposit's counts on the same inputs
    tile = DepositTile(tile=32, chunk=128, **{k: ZKW[k] for k in ("x_lo", "x_hi",
                                                                  "y_lo", "y_hi")})
    np.testing.assert_array_equal(pd(php, pdep)[0].numpy(), tile(php, pdep)[0].numpy())


GRID = dict(lo=(-1, -1, -1), hi=(42, 42, 42))


def test_grid_matches_jax_and_bruteforce(rng):
    """tests/test_deposit.py:60-70."""
    hp, dep = random_case(rng)
    php, pdep = port_records(hp, dep)
    fn = make_grid_deposit(max_per_cell=256, **GRID)
    assert fn.returns_aux
    got = fn(php, pdep)
    assert int(got[2]) == 0
    _check(got, jax.jit(j_grid(max_per_cell=256, **GRID))(hp, dep))
    _check_bruteforce(got, php, pdep)


def test_grid_overflow_is_loud(rng):
    """tests/test_deposit.py:73-86: clustered deposits overfill cells; the
    overflow equals JAX's and the result is a subset of the bruteforce."""
    hp, dep = random_case(rng)
    dep = dep.replace(pos=jnp.asarray(np.asarray(dep.pos) * 0.05 + 20.0, jnp.float32))
    php, pdep = port_records(hp, dep)
    got = make_grid_deposit(max_per_cell=2, **GRID)(php, pdep)
    want = jax.jit(j_grid(max_per_cell=2, **GRID))(hp, dep)
    assert int(got[2]) > 0
    _check(got, want)
    bc, _ = deposit_bruteforce(php, pdep)
    assert bool((got[0] <= bc).all())
    empty = make_grid_deposit(**GRID)(php, pdep.replace(valid=torch.zeros_like(pdep.valid)))
    assert float(empty[0].abs().sum()) == 0.0 and float(empty[1].abs().sum()) == 0.0
