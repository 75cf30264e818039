"""Deposit: the port's bruteforce oracle and tile deposit (host side + the
kernel's plain twin) vs the JAX package's ``deposit_bruteforce`` and
``PallasDepositTile(bucket2d=False, interpret=True)``, on the uniform and
wall distributions of tests/test_deposit.py; the packed-layout rounds vs
the hit-point-order rounds.  The CUDA kernel is held against its twin on
the card in tests/test_torch_cuda.py.

Counts are sums of 0/1 in fp32 and must be equal.  Flux sums agree to
rtol 2e-4 / atol 1e-4 (the tests/test_deposit.py tolerance: the summation
order differs between a matmul, a sorted lane walk and JAX's sort, whose
order among equal keys is unspecified).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import port_records as _port
from torch_port_util import random_case as _random_case
from torch_port_util import wall_case as _wall_case
from raytrace3_tpu.ops.deposit_pallas import PallasDepositTile
from raytrace3_tpu.render.deposit import deposit_bruteforce as j_bruteforce

from raytrace3_tpu_torch.ops import deposit_kernel, lane_kernel
from raytrace3_tpu_torch.ops.deposit_kernel import (DepositTile, deposit_tile,
                                                    deposit_tile_plain,
                                                    make_tile_deposit)
from raytrace3_tpu_torch.render.deposit import deposit_bruteforce

KW = dict(x_lo=-8.0, x_hi=48.0, y_lo=-8.0, y_hi=88.0)


def _check(cnt, tao, want_cnt, want_tao):
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(want_cnt))
    np.testing.assert_allclose(np.asarray(tao), np.asarray(want_tao),
                               rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["uniform", "wall"])
def test_bruteforce_matches_jax(rng, case):
    hp, dep = (_random_case if case == "uniform" else _wall_case)(rng)
    want = j_bruteforce(hp, dep)
    _check(*deposit_bruteforce(*_port(hp, dep), chunk=1000), *want)


@pytest.mark.parametrize("case", ["uniform", "wall"])
@pytest.mark.parametrize("tile,chunk", [(32, 128), (128, 256)])
def test_tile_deposit_matches_pallas_and_bruteforce(rng, case, tile, chunk):
    hp, dep = (_random_case if case == "uniform" else _wall_case)(rng)
    php, pdep = _port(hp, dep)
    got_cnt, got_tao, ovf = DepositTile(tile=tile, chunk=chunk, **KW)(php, pdep)
    assert int(ovf) == 0
    jd = PallasDepositTile(tile=tile, chunk=chunk, bucket2d=False,
                           interpret=True, **KW)
    want_cnt, want_tao, _ = jax.jit(jd)(hp, dep)
    _check(got_cnt.numpy(), got_tao.numpy(), want_cnt, want_tao)
    bf_cnt, bf_tao = deposit_bruteforce(php, pdep)
    _check(got_cnt.numpy(), got_tao.numpy(), bf_cnt.numpy(), bf_tao.numpy())


def test_host_side_matches_pallas(rng):
    """prepare / _dep_sorted / _window_lanes agree with the JAX host side:
    layout size, per-hit-point tile assignment, deposit keys and packing,
    and the tiles' interval lengths."""
    hp, dep = _wall_case(rng)
    php, pdep = _port(hp, dep)
    pd = DepositTile(tile=32, chunk=128, **KW)
    jd = PallasDepositTile(tile=32, chunk=128, bucket2d=False, interpret=True, **KW)
    assert pd._c_pad(hp.capacity) == jd._c_pad(hp.capacity)
    assert (pd.n_buckets, pd.y_stride, pd._sentinel_key()) == \
        (jd.n_buckets, jd.y_stride, jd._sentinel_key())
    prep_p, prep_j = pd.prepare(php), jd.prepare(hp)
    valid = np.asarray(hp.valid)
    # same tile for every valid hit point (order within a bucket may differ)
    np.testing.assert_array_equal((prep_p.g.numpy() // 32)[valid],
                                  (np.asarray(prep_j.g) // 32)[valid])
    np.testing.assert_array_equal(prep_p.lo_keys.numpy(), np.asarray(prep_j.lo_keys))
    np.testing.assert_array_equal(prep_p.hi_keys.numpy(), np.asarray(prep_j.hi_keys))
    dk_p, dp_p, Dp_p = pd._dep_sorted(pdep, 128)
    dk_j, _, dp_j, Dp_j = jd._dep_sorted(dep, 128)
    assert Dp_p == Dp_j
    np.testing.assert_array_equal(dk_p.numpy(), np.asarray(dk_j))
    np.testing.assert_array_equal(np.sort(dp_p.numpy(), 1), np.sort(np.asarray(dp_j), 1))
    n_tiles = prep_p.packed.shape[0] // 32
    sk_p, ek_p = pd._window_lanes(prep_p, dk_p, n_tiles)
    sk_j, ek_j = jd._window_lanes(prep_j, dk_j, n_tiles)
    np.testing.assert_array_equal(sk_p.numpy(), np.asarray(sk_j))
    np.testing.assert_array_equal(ek_p.numpy(), np.asarray(ek_j))


def test_empty_and_invalid(rng):
    hp, dep = _random_case(rng, C=100, D=200)
    php, pdep = _port(hp, dep)
    pd = make_tile_deposit(**KW)
    cnt, tao, _ = pd(php, pdep.replace(valid=torch.zeros_like(pdep.valid)))
    assert float(cnt.abs().sum()) == 0.0 and float(tao.abs().sum()) == 0.0
    cnt, tao, _ = pd(php.replace(valid=torch.zeros_like(php.valid)), pdep)
    assert float(cnt.abs().sum()) == 0.0
    empty = pdep.replace(pos=pdep.pos[:0], n=pdep.n[:0], flux=pdep.flux[:0],
                         valid=pdep.valid[:0])
    cnt, tao, _ = pd(php, empty)
    assert float(cnt.abs().sum()) == 0.0


def test_plain_step_size_does_not_change_the_result(rng):
    hp, dep = _wall_case(rng)
    php, pdep = _port(hp, dep)
    pd = DepositTile(tile=32, chunk=128, **KW)
    prep = pd.prepare(php)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(php.valid, php.r2, -1.0)
    dkeys, dep_packed, _ = pd._dep_sorted(pdep, 128)
    sk, ek = pd._window_lanes(prep, dkeys, packed.shape[0] // 32)
    sk, ek = sk.int(), ek.int()
    a = deposit_tile_plain(sk, ek, packed, dep_packed)
    b = deposit_tile_plain(sk, ek, packed, dep_packed, pairs_per_step=32 * 7)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    before = deposit_kernel.KERNEL.launches
    np.testing.assert_array_equal(deposit_tile(sk, ek, packed, dep_packed).numpy(),
                                  a.numpy())
    assert deposit_kernel.KERNEL.launches == before


def test_launch_geometry_covers_every_slot_once():
    """The tile and block kernels' launch geometry for every tile the
    wrappers take (1..1024): within each lane split every slot of the tile
    is one thread's exactly once, the block fits the kernels' thread bound,
    and shared memory holds the staging ring and the splits' partial sums
    within the 48 KB a block gets without opting in (an H100 block may opt
    in to 227 KB)."""
    for tile in range(1, 1025):
        g = deposit_kernel.deposit_geometry(tile)
        assert g.gsplits == deposit_kernel.GRID_SPLITS
        assert g.threads == g.slot_threads * g.splits
        assert 1 <= g.threads <= deposit_kernel.MAX_THREADS
        assert g.shared_bytes <= deposit_kernel.MAX_SHARED_BYTES <= 227 * 1024
        assert g.shared_bytes >= max(
            deposit_kernel.RING * deposit_kernel.STAGED_ROWS * deposit_kernel.STAGE_LANES * 4,
            (g.splits - 1) * tile * 16)
        for p in range(g.splits):
            threads = range(p * g.slot_threads, (p + 1) * g.slot_threads)
            assert {g.split_of(t) for t in threads} == {p}
            slots = [s for t in threads for s in g.slots_of(t)]
            assert sorted(slots) == list(range(tile))
    with pytest.raises(ValueError):
        deposit_kernel.deposit_geometry(1025)


def test_launch_geometry_takes_the_kernels_grid_splits():
    """deposit_geometry's grid splits are each kernel's: GRID_SPLITS for the
    tile, block and stream deposits, one for the lane deposit (its blocks
    follow the parts of each tile's run); the rest of the geometry does not
    depend on them, and fewer than one is refused."""
    for tile in (30, 128, 256, 1024):
        g8 = deposit_kernel.deposit_geometry(tile)
        g1 = deposit_kernel.deposit_geometry(tile, lane_kernel.LANE_GRID_SPLITS)
        assert g8.gsplits == deposit_kernel.GRID_SPLITS and g1.gsplits == 1
        assert (g1.threads, g1.splits, g1.shared_bytes) == (g8.threads, g8.splits,
                                                            g8.shared_bytes)
    with pytest.raises(ValueError):
        deposit_kernel.deposit_geometry(256, 0)


def test_launch_geometry_constants_match_the_header():
    """The wrapper's copies of csrc/deposit_stage.cuh's constants are the
    header's (the kernels refuse any other geometry at launch)."""
    header = (Path(deposit_kernel.__file__).parent.parent / "csrc" /
              "deposit_stage.cuh").read_text()
    consts = {name: eval(expr, {}) for name, expr in
              re.findall(r"constexpr int (k\w+) = ([\d *]+);", header)}
    want = {
        "kSlotsPerThread": deposit_kernel.SLOTS_PER_THREAD,
        "kStageLanes": deposit_kernel.STAGE_LANES,
        "kRing": deposit_kernel.RING,
        "kRows": deposit_kernel.STAGED_ROWS,
        "kMaxThreads": deposit_kernel.MAX_THREADS,
        "kMinBlocks": 2,
        "kMaxTile": 1024,
        "kMaxSharedBytes": deposit_kernel.MAX_SHARED_BYTES,
    }
    assert {name: consts.get(name) for name in want} == want


def test_float64_sums_keep_the_plain_twin(rng):
    """The plain twin with its flux summed in float64 has the same counts
    and, to float32 rounding, the same flux."""
    hp, dep = _wall_case(rng)
    php, pdep = _port(hp, dep)
    pd = DepositTile(tile=32, chunk=128, **KW)
    prep = pd.prepare(php)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(php.valid, php.r2, -1.0)
    dkeys, dep_packed, _ = pd._dep_sorted(pdep, 128)
    sk, ek = pd._window_lanes(prep, dkeys, packed.shape[0] // 32)
    sk, ek = sk.int(), ek.int()
    a = deposit_tile_plain(sk, ek, packed, dep_packed)
    b = deposit_tile_plain(sk, ek, packed, dep_packed, sum_dtype=torch.float64)
    assert b.dtype == torch.float32 and float(a[:, 0].sum()) > 0
    np.testing.assert_array_equal(b[:, 0].numpy(), a[:, 0].numpy())
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_packed_rounds_match_hp_space(rng):
    """photon_rounds in layout space (pack_state / packed_call / one unpack)
    equals the hit-point-order path with the same kernel and draws
    (tests/test_deposit.py:399-449)."""
    from raytrace3_tpu_torch.core.sampling import GeneratorDraws
    from raytrace3_tpu_torch.render.camera import emit_rays
    from raytrace3_tpu_torch.render.eye import eye_pass
    from raytrace3_tpu_torch.render.sppm import photon_rounds
    from raytrace3_tpu_torch.scenes import full, reference_camera

    scene = full(atlas_res=16, device="cpu").replace(bezier_compact_frac=0.2)
    org, dirs = emit_rays(reference_camera(16, 16, device="cpu"))
    php, _ = eye_pass(scene, org, dirs, 512, 4, compact_schedule=((1, 0.5),))
    depo = make_tile_deposit(tile=128, chunk=256, x_lo=-4.0, x_hi=104.0,
                             y_lo=-6.0, y_hi=88.0)

    class HpSpace:                         # hides packed_call
        returns_aux = True
        prepare = depo.prepare

        def __call__(self, h, d, prep=None):
            return depo(h, d, prep=prep)

    run = lambda fn: photon_rounds(scene, GeneratorDraws(torch.Generator().manual_seed(5)),
                                   php, 2, 256, max_depth=4, deposit_fn=fn, regen=True)
    hp_p, em_p, dr_p = run(depo)
    hp_r, em_r, dr_r = run(HpSpace())
    assert float(em_p) == float(em_r) and int(dr_p) == int(dr_r) == 0
    assert float(hp_p.nphot.sum()) > 0
    np.testing.assert_allclose(hp_p.r2.numpy(), hp_r.r2.numpy(), rtol=1e-6)
    np.testing.assert_allclose(hp_p.tao.numpy(), hp_r.tao.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(hp_p.nphot.numpy(), hp_r.nphot.numpy(), rtol=1e-6)
