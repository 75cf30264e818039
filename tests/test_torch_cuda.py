"""The port's CUDA kernels against their plain PyTorch twins, on the card,
and the port's dot product on the card against the CPU's.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; the repository's conftest imports JAX, so on such a machine run
it with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels are built with -fmad=false and evaluate in the
plain twins' operation order, so Newton outputs and deposit counts agree
exactly; deposit flux sums (tile, block, stream and lane deposits, the
lane transpose) differ only in summation order (rtol 1e-5; the stream and
lane deposits' and the lane transpose's against their twins summed in
float64).  The lane transpose adds without atomics, so two calls agree bit
for bit.
"""

import numpy as np
import pytest
import torch

from raytrace3_tpu_torch.core.types import Deposits, HitPoints
from raytrace3_tpu_torch.ops import deposit_kernel, lane_kernel, newton_kernel
from raytrace3_tpu_torch.ops.cuda_build import ptr
from raytrace3_tpu_torch.ops.deposit_kernel import (DepositBlock, DepositTile,
                                                    deposit_block, deposit_block_plain,
                                                    deposit_geometry, deposit_tile,
                                                    deposit_tile_plain)
from raytrace3_tpu_torch.ops.lane_kernel import (DepositLane, DepositStream,
                                                 deposit_lane, deposit_lane_bwd,
                                                 deposit_lane_bwd_plain,
                                                 deposit_lane_plain, deposit_stream,
                                                 deposit_stream_plain)
from raytrace3_tpu_torch.ops.newton_kernel import (MAX_PATCHES, RAYS_PER_BLOCK,
                                                   drain_schedule, open_pairs, solve,
                                                   solve_plain)
from raytrace3_tpu_torch.scenes import _teapot_ctrl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _teapot_rays(n, seed, scale, device):
    ctrl = _teapot_ctrl().numpy()
    rng = np.random.default_rng(seed)
    org = np.tile(np.array([50.0, 35.0, 230.0], np.float32), (n, 1))
    d = ctrl.reshape(-1, 3).mean(0) + rng.normal(scale=scale, size=(n, 3)) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.as_tensor(np.asarray(x, np.float32), device=device)
            for x in (org, d, ctrl)]


@pytest.mark.parametrize("restarts", [8, 16])
def test_newton_kernel_matches_plain(cuda_device, restarts):
    org, d, ctrl = _teapot_rays(2048, 5, 20.0, cuda_device)
    before = newton_kernel.KERNEL.launches
    got = solve(org, d, ctrl, restarts=restarts)
    torch.cuda.synchronize()
    assert newton_kernel.KERNEL.launches == before + 1
    want = solve_plain(org, d, ctrl, restarts=restarts)
    assert int(want[4].sum()) > 100
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _assert_newton_exact(org, d, ctrl, restarts):
    """One launch, every output equal to the plain twin's; returns the twin's."""
    before = newton_kernel.KERNEL.launches
    got = solve(org, d, ctrl, restarts=restarts)
    torch.cuda.synchronize()
    assert newton_kernel.KERNEL.launches == before + 1
    want = solve_plain(org, d, ctrl, restarts=restarts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return want


@pytest.mark.parametrize("restarts", [1, 8, 16, 128])
@pytest.mark.parametrize("n_rays", [1, 2 * RAYS_PER_BLOCK + 7])
def test_newton_kernel_exact_at_every_restart_count(cuda_device, restarts, n_rays):
    """Restarts 1 to 128 (1 to 128 patches a lane group, 256 to 2 pairs a
    drain step), one ray, and rays that leave the last block part full."""
    org, d, ctrl = _teapot_rays(n_rays, 7, 6.0, cuda_device)
    want = _assert_newton_exact(org, d, ctrl, restarts)
    assert n_rays == 1 or int(want[4].sum()) > n_rays // 4


def test_fma32_equals_the_cards_fused_multiply_add(cuda_device):
    """The twin's ``fma32`` (on the CPU) equals ``__fmaf_rn`` on the card
    (``fma32_card``) bit for bit, on random triples and on triples whose
    float64 sum lands on a float32 midpoint: the Newton kernel contracts
    at the places the twin calls ``fma32``."""
    rng = np.random.default_rng(9)
    n = 1 << 16
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    a[: n // 2] = rng.uniform(1.0, 2.0, n // 2)
    b[: n // 2] = (2.0 ** -24 / a[: n // 2].astype(np.float64)).astype(np.float32)
    c[: n // 2] = rng.uniform(1.0, 2.0, n // 2)
    twin = newton_kernel.fma32(*(torch.as_tensor(x) for x in (a, b, c)))
    card = newton_kernel.fma32_card(*(torch.as_tensor(x, device=cuda_device)
                                      for x in (a, b, c)))
    torch.testing.assert_close(card.cpu(), twin, rtol=0, atol=0)


@pytest.mark.parametrize("restarts", [4, 8, 16, 32, 64])
def test_newton_kernel_exact_on_the_restart_study_rays(cuda_device, restarts):
    """The restart study's three populations (scripts/torch_newton_restart_
    study.py), every 256th ray, at the restart counts the study runs."""
    from raytrace3_tpu_torch.testing import load_script

    study = load_script("torch_newton_restart_study")
    ctrl = study.study_ctrl(cuda_device)
    for name, (o, d) in study.populations(ctrl).items():
        org, dir = (torch.as_tensor(np.ascontiguousarray(a[::256]), device=cuda_device)
                    for a in (o, d))
        want = _assert_newton_exact(org, dir, ctrl, restarts)
        assert name == "eye" or int(want[4].sum()) > 100, name


@pytest.mark.parametrize("n_patches", [1, MAX_PATCHES])
def test_newton_kernel_exact_at_the_patch_limits(cuda_device, n_patches):
    """One patch, and the most the kernel takes (eight shifted copies of the
    teapot, boxes overlapping): shared memory past 48 KB needs the opt-in."""
    org, d, teapot = _teapot_rays(300, 8, 10.0, cuda_device)
    if n_patches == 1:
        ctrl = teapot[5:6].contiguous()
        d = ctrl.reshape(-1, 3).mean(0) - org
        d = d + 0.3 * torch.as_tensor(np.random.default_rng(8).normal(size=d.shape),
                                      dtype=torch.float32, device=cuda_device)
        d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    else:
        shift = torch.tensor([1.5, 0.75, -1.0], device=cuda_device)
        ctrl = torch.cat([teapot + k * shift for k in range(n_patches // 32)]).contiguous()
    assert ctrl.shape[0] == n_patches
    want = _assert_newton_exact(org, d, ctrl, 8)
    assert int(want[4].sum()) > 30


@pytest.mark.parametrize("restarts", [1, 8])
def test_newton_kernel_exact_when_every_box_opens(cuda_device, restarts):
    """Rays starting inside all 256 patch boxes open every (ray, patch)
    pair: each full block fills and drains its queue more than once."""
    rng = np.random.default_rng(restarts)
    g = rng.uniform(-1.0, 1.0, (MAX_PATCHES, 16, 3))
    g[:, 0], g[:, 15] = -1.0, 1.0                     # every box is [-1, 1]^3
    n = RAYS_PER_BLOCK + 9
    org = rng.uniform(-0.5, 0.5, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org, d, ctrl = (torch.as_tensor(x.astype(np.float32), device=cuda_device)
                    for x in (org, d, g.reshape(MAX_PATCHES, 4, 4, 3)))
    gate = open_pairs(org, d, ctrl)
    assert bool(gate.all())
    sched = drain_schedule(gate, restarts)
    assert sched["drains"] > sched["blocks"]
    want = _assert_newton_exact(org, d, ctrl, restarts)
    assert int(want[4].sum()) > n // 2


@pytest.mark.parametrize("restarts", [8, 16])
def test_newton_kernel_exact_on_tied_patches(cuda_device, restarts):
    """Patches repeated inside a lane group (at 8 restarts) and across
    groups give exact ties in t: the winner is the lowest patch id, with
    the tied lanes' least u and v, as the twin's fold takes them."""
    org, d, teapot = _teapot_rays(400, 9, 6.0, cuda_device)
    ctrl = torch.cat([teapot[:8]] * 4).contiguous()
    want = _assert_newton_exact(org, d, ctrl, restarts)
    hit = want[4]
    assert int(hit.sum()) > 20 and int(want[3][hit].max()) < 8


def test_newton_kernel_refuses_a_shape_it_cannot_take(cuda_device):
    """More patches than MAX_PATCHES or none, restarts that do not divide
    128, or a (gu, gv) grid of another count: the C entry point returns
    cudaErrorInvalidValue (1) and launches nothing; the wrapper refuses
    first."""
    from raytrace3_tpu_torch.ops.cuda_build import ptr as p

    org, d, teapot = _teapot_rays(8, 0, 10.0, cuda_device)
    big = torch.cat([teapot] * (MAX_PATCHES // 32 + 1)).contiguous()
    with pytest.raises(ValueError):
        solve(org, d, big)
    out = [torch.empty(8, dtype=dt, device=cuda_device)
           for dt in (torch.float32, torch.float32, torch.float32, torch.int32, torch.bool)]
    launch = lambda ctrl, b, restarts, gu, gv: newton_kernel.KERNEL.launch(
        cuda_device, p(org), p(d), p(ctrl), 8, b, restarts, gu, gv, 10, 1e-4,
        *(p(x) for x in out))
    launch(teapot, 32, 8, 2, 4)
    torch.cuda.synchronize()
    for bad in [(big, big.shape[0], 8, 2, 4), (teapot, 32, 6, 2, 3), (teapot, 32, 8, 2, 3),
                (teapot, 0, 8, 2, 4)]:
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            launch(*bad)


def test_newton_wrapper_checks_its_inputs(cuda_device):
    org, d, ctrl = _teapot_rays(8, 0, 10.0, cuda_device)
    with pytest.raises(TypeError):
        solve(org.double(), d, ctrl)
    with pytest.raises(ValueError):
        solve(org, d.t().contiguous().t(), ctrl)        # not contiguous
    with pytest.raises(ValueError):
        solve(org, d, ctrl.cpu())                       # another device


def _wall_case(rng, C, D, device):
    """Most hit points and deposits on an x = 1 wall (tests/test_deposit.py)."""
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    hpos = rng.uniform(0, 40, size=(C, 3))
    wh = rng.uniform(size=C) < 0.5
    hpos[wh] = np.c_[np.ones(wh.sum()), rng.uniform(0, 80, wh.sum()),
                     rng.uniform(0, 160, wh.sum())]
    dpos = rng.uniform(0, 40, size=(D, 3))
    wd = rng.uniform(size=D) < 0.6
    dpos[wd] = np.c_[1.0 + rng.uniform(-0.05, 0.05, wd.sum()),
                     rng.uniform(0, 80, wd.sum()), rng.uniform(0, 160, wd.sum())]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    hp = HitPoints(pos=f32(hpos), n=f32(unit(rng.normal(size=(C, 3)))),
                   wgt=f32(rng.uniform(0, 1, (C, 3))),
                   pixel=torch.arange(C, dtype=torch.int32, device=device),
                   valid=torch.as_tensor(rng.uniform(size=C) > 0.1, device=device),
                   r2=f32(rng.uniform(0.5, 2.0, C)), nphot=f32(np.zeros(C)),
                   tao=f32(np.zeros((C, 3))))
    dep = Deposits(pos=f32(dpos), n=f32(unit(rng.normal(size=(D, 3)))),
                   flux=f32(rng.uniform(0, 5, (D, 3))),
                   valid=torch.as_tensor(rng.uniform(size=D) > 0.2, device=device))
    return hp, dep


def test_deposit_kernel_matches_plain(cuda_device):
    hp, dep = _wall_case(np.random.default_rng(0), 20000, 200000, cuda_device)
    pd = DepositTile(tile=256, chunk=2048, x_lo=-8.0, x_hi=48.0, y_lo=-8.0, y_hi=88.0)
    prep = pd.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    dkeys, dep_packed, _ = pd._dep_sorted(dep, pd.chunk)
    sk, ek = pd._window_lanes(prep, dkeys, packed.shape[0] // pd.tile)
    sk, ek = sk.int().contiguous(), ek.int().contiguous()
    before = deposit_kernel.KERNEL.launches
    got = deposit_tile(sk, ek, packed, dep_packed)
    torch.cuda.synchronize()
    assert deposit_kernel.KERNEL.launches == before + 1
    want = deposit_tile_plain(sk, ek, packed, dep_packed)
    assert float(want[:, 0].sum()) > 1000
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(TypeError):
        deposit_tile(sk.long(), ek, packed, dep_packed)


def _assert_deposit_equal(got, want):
    """Counts exact, flux to rtol 1e-5 (summation order only)."""
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _box_slots_and_lanes(rng, c_pad, Dp, device, dep_offset=0):
    """Hit slots and deposit lanes in one 6-unit box (a few % of pairs
    pass), every 7th slot padding (r2 = -1); ``dep_packed`` is (16, Dp),
    contiguous, starting ``dep_offset`` floats into its storage."""
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    packed = np.zeros((c_pad, 8), np.float32)
    packed[:, :3] = rng.uniform(0, 6, (c_pad, 3))
    packed[:, 3:6] = unit(rng.normal(size=(c_pad, 3)))
    packed[:, 6] = rng.uniform(0.5, 2.0, c_pad)
    packed[::7, 6] = -1.0
    dep = np.zeros((16, Dp), np.float32)
    dep[0:3] = rng.uniform(0, 6, (3, Dp))
    dep[3:6] = unit(rng.normal(size=(Dp, 3))).T
    dep[6:9] = rng.uniform(0, 5, (3, Dp))
    store = torch.zeros(16 * Dp + dep_offset, dtype=torch.float32, device=device)
    dep_packed = store[dep_offset:].view(16, Dp)
    dep_packed.copy_(torch.as_tensor(dep))
    return torch.as_tensor(packed, device=device), dep_packed


def _ragged_intervals(rng, n_tiles, K, Dp, device):
    """(n_tiles, K) intervals inside [0, Dp) starting at every residue mod
    4: empty ones (e = s and e < s), one-lane ones, short ones, long ones
    crossing several 512-lane stages (so several of a tile's 8 blocks take
    stages), and one ending at Dp."""
    s = rng.integers(0, Dp, (n_tiles, K))
    length = rng.choice([0, 1, 2, 3, 5, 17, 511, 513, 1500], (n_tiles, K))
    e = np.minimum(s + length, Dp)
    e[0, 0] = max(int(s[0, 0]) - 3, 0)          # e < s
    s[1 % n_tiles, 0], e[1 % n_tiles, 0] = Dp - 1, Dp
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)
    return i32(s), i32(e)


@pytest.mark.parametrize("tile", [30, 32, 96, 256, 1000, 1001])
@pytest.mark.parametrize("dp, offset", [(4096, 0), (4001, 0), (4096, 1)])
def test_tile_kernel_ragged_shapes(cuda_device, tile, dp, offset):
    """Kernel #2 at tiles that are no multiple of 4 slots or of a warp,
    over intervals at every lane residue mod 4, empty and one-lane ones;
    with Dp or the deposit array off 16-byte alignment (4-byte copies)."""
    rng = np.random.default_rng(tile + dp + offset)
    n_tiles, K = 6, 5
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, dp, cuda_device, offset)
    sk, ek = _ragged_intervals(rng, n_tiles, K, dp, cuda_device)
    want = deposit_tile_plain(sk, ek, packed, dep_packed)
    assert float(want[:, 0].sum()) > 100
    before = deposit_kernel.KERNEL.launches
    _assert_deposit_equal(deposit_tile(sk, ek, packed, dep_packed), want)
    torch.cuda.synchronize()
    assert deposit_kernel.KERNEL.launches == before + 1


@pytest.mark.parametrize("tile", [30, 32, 96, 1000, 1001])
def test_block_kernel_under_a_cut_cap(cuda_device, tile):
    """Kernel #5 at ragged tiles on a work list cut inside a tile's run of
    items, with every third computing item switched off (wcmp = 0): the
    straddling tile keeps its partial sums, the tiles beyond the cut read
    0, and everything matches the plain twin."""
    hp, dep = _wall_case(np.random.default_rng(4), 20000, 200000, cuda_device)
    pd = DepositBlock(tile=tile, wchunk=128, work_cap=1 << 20, x_lo=-8.0, x_hi=48.0,
                      y_lo=-8.0, y_hi=88.0)
    prep = pd.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    n_tiles = packed.shape[0] // tile
    dkeys, dep_packed, Dp = pd._dep_sorted(dep, pd.wchunk)
    wt, blk, wcmp, overflow, total = pd.work_list(prep, dkeys, n_tiles, Dp)
    assert int(overflow) == 0
    wcmp = wcmp.clone()
    wcmp[torch.nonzero(wcmp).flatten()[::3]] = 0
    # The cut: one item into the run of a tile in the middle of the list
    # that has at least three computing items.
    per_tile = torch.bincount(wt.long()[wcmp != 0], minlength=n_tiles)
    first = torch.searchsorted(wt, torch.arange(n_tiles, dtype=torch.int32,
                                                device=cuda_device))
    cands = torch.nonzero(per_tile >= 3).flatten()
    cut = int(cands[len(cands) // 2])
    W = int(first[cut]) + 2
    args = (wt[:W].contiguous(), blk[:W].contiguous(), wcmp[:W].contiguous(), packed,
            dep_packed, tile, pd.wchunk)
    want = deposit_block_plain(*args)
    rows = want.reshape(n_tiles, tile, 8)
    assert float(rows[cut + 1:].abs().sum()) == 0.0 and float(rows[:cut, :, 0].sum()) > 1000
    got = deposit_block(*args)
    torch.cuda.synchronize()
    _assert_deposit_equal(got, want)
    assert float(got.reshape(n_tiles, tile, 8)[cut + 1:].abs().sum()) == 0.0


def test_deposit_kernels_refuse_a_foreign_geometry(cuda_device):
    """The tile kernel launches with deposit_geometry's launch geometry and
    refuses any other (a thread short, a lane split more, too little shared
    memory) with cudaErrorInvalidValue (1), so that a geometry the compiled
    constants do not cover never runs."""
    rng = np.random.default_rng(0)
    tile, n_tiles, K, dp = 96, 3, 4, 2048
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, dp, cuda_device)
    sk, ek = _ragged_intervals(rng, n_tiles, K, dp, cuda_device)
    g = deposit_geometry(tile)
    out = torch.empty((n_tiles * tile, 8), dtype=torch.float32, device=cuda_device)
    scratch = torch.empty((g.gsplits, n_tiles * tile, 4), dtype=torch.float32,
                          device=cuda_device)
    launch = lambda *geom: deposit_kernel.KERNEL.launch(
        cuda_device, ptr(sk), ptr(ek), n_tiles, K, tile, ptr(packed), ptr(dep_packed), dp,
        ptr(out), *geom, ptr(scratch))
    launch(g.threads, g.splits, g.gsplits, g.shared_bytes)
    torch.cuda.synchronize()
    _assert_deposit_equal(out, deposit_tile_plain(sk, ek, packed, dep_packed))
    for bad in [(g.threads - 1, g.splits, g.gsplits, g.shared_bytes),
                (g.threads + g.slot_threads, g.splits + 1, g.gsplits, g.shared_bytes),
                (g.threads, g.splits, g.gsplits, g.shared_bytes - 4),
                (g.threads, g.splits, 0, g.shared_bytes)]:
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            launch(*bad)


#: (hit points, deposits): a small case and the train path's sizes
#: (C = 1.5 x 256^2 hit points, 14 x 32768 deposits).
LANE_SIZES = {"small": (20000, 100000), "main": (98304, 458752)}
LANE_KW = dict(tile=256, chunk=512, work_cap=65536, x_lo=-8.0, x_hi=48.0,
               y_lo=-8.0, y_hi=88.0, z_lo=-8.0, z_hi=168.0)


def _lane_round(size, device):
    C, D = LANE_SIZES[size]
    hp, dep = _wall_case(np.random.default_rng(1), C, D, device)
    pd = DepositLane(**LANE_KW)
    prep = pd.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    n_tiles = packed.shape[0] // pd.tile
    dkeys, dep_packed, Dp = pd._dep_sorted(dep, pd.chunk)
    sk, ek = pd._window_lanes(prep, dkeys, n_tiles)
    return pd, packed, dep_packed, sk, ek, n_tiles, Dp, hp, dep, prep


@pytest.mark.parametrize("size", sorted(LANE_SIZES))
def test_lane_kernels_match_plain(cuda_device, size):
    pd, packed, dep_packed, sk, ek, n_tiles, Dp, *_ = _lane_round(size, cuda_device)
    lo, hi, wa, wb, overflow = pd.forward_items(sk, ek, n_tiles, Dp)
    assert int(overflow) == 0
    before = (lane_kernel.FORWARD.launches, lane_kernel.BACKWARD.launches)
    got = deposit_lane(lo, hi, wa, wb, packed, dep_packed)
    torch.cuda.synchronize()
    want = deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed)
    assert float(want[:, 0].sum()) > 1000
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

    items = pd.backward_items(sk, ek, n_tiles, Dp)
    u = torch.rand((packed.shape[0], 3), generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    got = deposit_lane_bwd(*items, packed, u, dep_packed, pd.tile, pd.chunk)
    torch.cuda.synchronize()
    want = deposit_lane_bwd_plain(*items, packed, u, dep_packed, pd.tile)
    assert float(want.sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (lane_kernel.FORWARD.launches, lane_kernel.BACKWARD.launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):
        deposit_lane(lo.long(), hi, wa, wb, packed, dep_packed)


def test_lane_vjp_on_the_card_matches_the_cpu(cuda_device):
    """DepositLane(differentiable=True) on the card (kernels #3 and #4)
    against the same call on the CPU (the plain twins): counts exact,
    d_tao, d_wgt and d_flux to rtol 1e-5."""
    pd, *_, hp, dep, prep = _lane_round("small", cuda_device)
    pd.differentiable = True
    tgt = torch.as_tensor(np.random.default_rng(2).normal(size=(hp.capacity, 3)),
                          dtype=torch.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        h = hp.replace(**{f: getattr(hp, f).to(dev) for f in ("pos", "n", "wgt", "pixel",
                                                             "valid", "r2", "nphot", "tao")})
        d = dep.replace(**{f: getattr(dep, f).to(dev) for f in ("pos", "n", "flux", "valid")})
        wgt, flux = h.wgt.clone().requires_grad_(True), d.flux.clone().requires_grad_(True)
        cnt, tao, ovf = pd(h.replace(wgt=wgt), d.replace(flux=flux))
        (tao * tgt.to(dev)).sum().backward()
        out[dev.type] = [x.detach().cpu() for x in (cnt, tao, wgt.grad, flux.grad)] + [int(ovf)]
    g, c = out["cuda"], out["cpu"]
    torch.testing.assert_close(g[0], c[0], rtol=0, atol=0)
    for a, b in zip(g[1:4], c[1:4]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert g[4] == c[4] == 0 and float(c[3].abs().sum()) > 0


@pytest.mark.parametrize("tile", [512, 1024])
def test_block_kernel_matches_plain(cuda_device, tile):
    """Kernel #5 at the CLI's two tile sizes (1024 threads a block at the
    reference1024 preset's)."""
    hp, dep = _wall_case(np.random.default_rng(3), 20000, 200000, cuda_device)
    pd = DepositBlock(tile=tile, wchunk=1024, work_cap=65536, x_lo=-8.0, x_hi=48.0,
                      y_lo=-8.0, y_hi=88.0)
    prep = pd.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    dkeys, dep_packed, Dp = pd._dep_sorted(dep, pd.wchunk)
    wt, blk, wcmp, overflow, _ = pd.work_list(prep, dkeys, packed.shape[0] // tile, Dp)
    assert int(overflow) == 0
    before = deposit_kernel.BLOCK_KERNEL.launches
    got = deposit_block(wt, blk, wcmp, packed, dep_packed, tile, pd.wchunk)
    torch.cuda.synchronize()
    assert deposit_kernel.BLOCK_KERNEL.launches == before + 1
    want = deposit_block_plain(wt, blk, wcmp, packed, dep_packed, tile, pd.wchunk)
    assert float(want[:, 0].sum()) > 1000
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(TypeError):
        deposit_block(wt.long(), blk, wcmp, packed, dep_packed, tile, pd.wchunk)


def test_stream_kernel_matches_plain(cuda_device):
    """Kernel #6 on the lane deposit's round, with the work cap cut to half
    the items so that tiles straddle it and beyond it read 0."""
    pd, packed, dep_packed, sk, ek, n_tiles, Dp, hp, dep, prep = _lane_round(
        "small", cuda_device)
    ps = DepositStream(**dict(LANE_KW, work_cap=int(pd.work_items(hp, dep, prep)) // 2))
    itf, itab, starts, ends, overflow = ps.stream_items(sk, ek, n_tiles, Dp)
    assert int(overflow) > 0
    before = lane_kernel.STREAM.launches
    got = deposit_stream(itf, itab, starts, ends, packed, dep_packed)
    torch.cuda.synchronize()
    assert lane_kernel.STREAM.launches == before + 1
    want = deposit_stream_plain(itf, itab, starts, ends, packed, dep_packed,
                                sum_dtype=torch.float64)
    assert float(want[:, 0].sum()) > 1000
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _stream_items(s, e, device):
    """Kernel #6's items for (n_tiles, K) intervals [s, e): each fetches from
    its start aligned down to 128 lanes, the mask packed in two 16-bit
    fields (an interval with e < s is an empty mask); tile i runs its K."""
    s, e = s.long(), e.long()
    f = s - s % 128
    itab = ((s - f) << 16) | torch.clamp_min(e - f, 0)
    n_tiles, K = s.shape
    starts = torch.arange(n_tiles, device=device) * K
    i32 = lambda x: x.reshape(-1).to(torch.int32).contiguous()
    return i32(f), i32(itab), i32(starts), i32(starts + K)


@pytest.mark.parametrize("tile", [30, 32, 96, 128, 1000, 1001])
@pytest.mark.parametrize("dp, offset", [(4096, 0), (4001, 0), (4096, 1)])
def test_stream_kernel_ragged_shapes(cuda_device, tile, dp, offset):
    """Kernel #6 at tiles that are no multiple of 4 slots or of a warp, over
    items whose masks start at every lane residue mod 4, empty and one-lane
    ones, one tile with an empty run; with Dp or the deposit array off
    16-byte alignment (4-byte copies).  Flux against the twin summed in
    float64."""
    rng = np.random.default_rng(tile + dp + offset + 1)
    n_tiles, K = 6, 5
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, dp, cuda_device, offset)
    itf, itab, starts, ends = _stream_items(*_ragged_intervals(rng, n_tiles, K, dp, cuda_device),
                                            cuda_device)
    ends[2] = starts[2]                       # tile 2 runs no item and reads 0
    args = (itf, itab, starts, ends, packed, dep_packed)
    want = deposit_stream_plain(*args, sum_dtype=torch.float64)
    assert float(want[:, 0].sum()) > 100
    before = lane_kernel.STREAM.launches
    got = deposit_stream(*args)
    torch.cuda.synchronize()
    assert lane_kernel.STREAM.launches == before + 1
    _assert_deposit_equal(got, want)
    assert float(got.reshape(n_tiles, tile, 8)[2].abs().sum()) == 0.0


@pytest.mark.parametrize("tile", [30, 32, 96, 1000, 1001])
def test_stream_kernel_under_a_cut_cap(cuda_device, tile):
    """Kernel #6 at ragged tiles on a work list cut one item into the run
    of a tile in the middle of the list: the straddling tile keeps its
    partial sums, the tiles beyond the cut read 0, and everything matches
    the twin summed in float64."""
    hp, dep = _wall_case(np.random.default_rng(5), 20000, 200000, cuda_device)
    ps = DepositStream(**dict(LANE_KW, tile=tile, chunk=256, work_cap=1 << 20))
    prep = ps.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    n_tiles = packed.shape[0] // tile
    dkeys, dep_packed, Dp = ps._dep_sorted(dep, ps.chunk)
    sk, ek = ps._window_lanes(prep, dkeys, n_tiles)
    itf, itab, starts, ends, overflow = ps.stream_items(sk, ek, n_tiles, Dp)
    assert int(overflow) == 0
    cands = torch.nonzero(ends - starts >= 3).flatten()
    cut = int(cands[len(cands) // 2])
    W = int(starts[cut]) + 2
    starts, ends = torch.clamp_max(starts, W), torch.clamp_max(ends, W)
    args = (itf[:W].contiguous(), itab[:W].contiguous(), starts, ends, packed, dep_packed)
    want = deposit_stream_plain(*args, sum_dtype=torch.float64)
    rows = want.reshape(n_tiles, tile, 8)
    assert float(rows[cut + 1:].abs().sum()) == 0.0 and float(rows[:cut, :, 0].sum()) > 1000
    got = deposit_stream(*args)
    torch.cuda.synchronize()
    _assert_deposit_equal(got, want)
    assert float(got.reshape(n_tiles, tile, 8)[cut + 1:].abs().sum()) == 0.0


def test_stream_kernel_refuses_a_foreign_geometry(cuda_device):
    """Kernel #6 launches with deposit_geometry's launch geometry and
    refuses any other with cudaErrorInvalidValue (1), as the tile kernel
    does."""
    rng = np.random.default_rng(1)
    tile, n_tiles, K, dp = 96, 3, 4, 2048
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, dp, cuda_device)
    items = _stream_items(*_ragged_intervals(rng, n_tiles, K, dp, cuda_device), cuda_device)
    g = deposit_geometry(tile)
    out = torch.empty((n_tiles * tile, 8), dtype=torch.float32, device=cuda_device)
    scratch = torch.empty((g.gsplits, n_tiles * tile, 4), dtype=torch.float32,
                          device=cuda_device)
    launch = lambda *geom: lane_kernel.STREAM.launch(
        cuda_device, *(ptr(x) for x in items), n_tiles, tile, ptr(packed), ptr(dep_packed), dp,
        ptr(out), *geom, ptr(scratch))
    launch(g.threads, g.splits, g.gsplits, g.shared_bytes)
    torch.cuda.synchronize()
    _assert_deposit_equal(out, deposit_stream_plain(*items, packed, dep_packed,
                                                    sum_dtype=torch.float64))
    for bad in [(g.threads - 1, g.splits, g.gsplits, g.shared_bytes),
                (g.threads + g.slot_threads, g.splits + 1, g.gsplits, g.shared_bytes),
                (g.threads, g.splits, g.gsplits, g.shared_bytes - 4),
                (g.threads, g.splits, 0, g.shared_bytes)]:
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            launch(*bad)


def _lane_items(s, e, device):
    """Kernel #3's items for (n_tiles, K) intervals [s, e): tile i runs
    items [i K, (i + 1) K)."""
    n_tiles, K = s.shape
    lo = torch.arange(n_tiles, dtype=torch.int32, device=device) * K
    flat = lambda x: x.reshape(-1).contiguous()
    return lo, (lo + K).contiguous(), flat(s), flat(e)


@pytest.mark.parametrize("tile", [30, 32, 96, 256, 1000, 1001])
@pytest.mark.parametrize("dp, offset", [(4096, 0), (4001, 0), (4096, 1)])
def test_lane_kernel_ragged_shapes(cuda_device, tile, dp, offset):
    """Kernel #3 at tiles that are no multiple of 4 slots or of a warp, over
    items whose masks start at every lane residue mod 4, empty and one-lane
    ones, one tile with an empty run; with Dp or the deposit array off
    16-byte alignment (4-byte copies).  Counts exact, flux against the twin
    summed in float64."""
    rng = np.random.default_rng(tile + dp + offset + 2)
    n_tiles, K = 6, 5
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, dp, cuda_device, offset)
    lo, hi, wa, wb = _lane_items(*_ragged_intervals(rng, n_tiles, K, dp, cuda_device),
                                 cuda_device)
    hi[2] = lo[2]                             # tile 2 runs no item and reads 0
    args = (lo, hi, wa, wb, packed, dep_packed)
    want = deposit_lane_plain(*args, sum_dtype=torch.float64)
    assert float(want[:, 0].sum()) > 100
    before = lane_kernel.FORWARD.launches
    got = deposit_lane(*args)
    torch.cuda.synchronize()
    assert lane_kernel.FORWARD.launches == before + 1
    _assert_deposit_equal(got, want)
    assert float(got.reshape(n_tiles, tile, 8)[2].abs().sum()) == 0.0


@pytest.mark.parametrize("tile", [30, 32, 96, 256, 1001])
def test_lane_kernel_under_a_cut_cap(cuda_device, tile):
    """Kernel #3 with the work cap cut one item into the run of a tile in
    the middle of the list (DepositLane.forward_items cuts the runs): the
    straddling tile keeps its partial sums, the tiles beyond read 0."""
    hp, dep = _wall_case(np.random.default_rng(6), 20000, 200000, cuda_device)
    pd = DepositLane(**dict(LANE_KW, tile=tile, chunk=256, work_cap=1 << 20))
    prep = pd.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    n_tiles = packed.shape[0] // tile
    dkeys, dep_packed, Dp = pd._dep_sorted(dep, pd.chunk)
    sk, ek = pd._window_lanes(prep, dkeys, n_tiles)
    lo, hi, _, _, overflow = pd.forward_items(sk, ek, n_tiles, Dp)
    assert int(overflow) == 0
    cands = torch.nonzero(hi - lo >= 3).flatten()
    cut = int(cands[len(cands) // 2])
    pd.work_cap = int(lo[cut]) + 2
    lo, hi, wa, wb, overflow = pd.forward_items(sk, ek, n_tiles, Dp)
    assert int(overflow) > 0 and int(hi[cut] - lo[cut]) == 2
    args = (lo, hi, wa, wb, packed, dep_packed)
    want = deposit_lane_plain(*args, sum_dtype=torch.float64)
    rows = want.reshape(n_tiles, tile, 8)
    assert float(rows[cut + 1:].abs().sum()) == 0.0 and float(rows[:cut, :, 0].sum()) > 1000
    got = deposit_lane(*args)
    torch.cuda.synchronize()
    _assert_deposit_equal(got, want)
    assert float(got.reshape(n_tiles, tile, 8)[cut + 1:].abs().sum()) == 0.0


def _bwd_items(rng, n_blocks, chunk, n_tiles, device):
    """Kernel #4's chunk-sorted items: 0 to 12 a chunk (chunks 1 and 3 none),
    each a random tile and a mask inside its chunk: one-lane, short, long
    and whole-chunk masks, and an empty one."""
    wt, wa, wb, run_lo, run_hi = [], [], [], [], []
    for b in range(n_blocks):
        k = 0 if b in (1, 3) else int(rng.integers(1, 13))
        run_lo.append(len(wt))
        for i in range(k):
            kind = rng.choice(["one", "short", "long", "whole", "empty"],
                              p=[.15, .45, .25, .1, .05])
            s = int(rng.integers(0, chunk))
            n = {"one": 1, "short": int(rng.integers(2, 40)), "long": chunk, "whole": chunk,
                 "empty": 0}[kind]
            if kind == "whole" or (b == 0 and i == 0):
                s, n = 0, chunk
            if b == 2 and i == 0:
                n = 1
            wt.append(int(rng.integers(0, n_tiles)))
            wa.append(b * chunk + s)
            wb.append(b * chunk + min(s + n, chunk))
        run_hi.append(len(wt))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return i32(run_lo), i32(run_hi), i32(wt), i32(wa), i32(wb)


def _misaligned(x, offset):
    """``x`` copied into storage starting ``offset`` floats in."""
    store = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    y = store[offset:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("tile", [30, 96, 256, 1001])
@pytest.mark.parametrize("chunk", [32, 100, 512, 1024])
@pytest.mark.parametrize("offset", [0, 1])
def test_lane_bwd_kernel_ragged_shapes(cuda_device, tile, chunk, offset):
    """Kernel #4 at ragged tiles and chunks (threads a chunk rounded up to a
    warp), items masking one lane, a few, or a whole chunk, empty runs (they
    read 0), exact duplicate deposits, and hit rows and cotangents off
    16-byte alignment (4-byte copies); against the twin summed in float64,
    and two calls bit for bit."""
    rng = np.random.default_rng(tile + chunk + offset)
    n_tiles, n_blocks = 5, 7
    Dp = n_blocks * chunk
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, Dp, cuda_device)
    dep_packed[:, 1::5] = dep_packed[:, :1]             # exact duplicates of lane 0
    u = torch.as_tensor(rng.uniform(0, 1, (n_tiles * tile, 3)).astype(np.float32),
                        device=cuda_device)
    packed, u = _misaligned(packed, offset), _misaligned(u, offset)
    items = _bwd_items(rng, n_blocks, chunk, n_tiles, cuda_device)
    args = (*items, packed, u, dep_packed, tile)
    want = deposit_lane_bwd_plain(*args, sum_dtype=torch.float64)
    assert float(want.sum()) > 10
    before = lane_kernel.BACKWARD.launches
    got = deposit_lane_bwd(*args, chunk)
    again = deposit_lane_bwd(*args, chunk)
    torch.cuda.synchronize()
    assert lane_kernel.BACKWARD.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    lanes = got.reshape(3, n_blocks, chunk)
    assert float(lanes[:, [1, 3]].abs().sum()) == 0.0


@pytest.mark.parametrize("tile", [32, 256, 1001])
def test_lane_bwd_kernel_under_a_cut_cap(cuda_device, tile):
    """Kernel #4 on DepositLane.backward_items cut by a work cap at half its
    items (W' = work_cap + K n_tiles): chunks lose items of their runs,
    empty runs read 0, and the sums match the twin summed in float64."""
    hp, dep = _wall_case(np.random.default_rng(7), 20000, 200000, cuda_device)
    pd = DepositLane(**dict(LANE_KW, tile=tile, chunk=256, work_cap=1 << 20))
    prep = pd.prepare(hp)
    packed = prep.packed.clone()
    packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
    n_tiles = packed.shape[0] // tile
    dkeys, dep_packed, Dp = pd._dep_sorted(dep, pd.chunk)
    sk, ek = pd._window_lanes(prep, dkeys, n_tiles)
    full = pd.backward_items(sk, ek, n_tiles, Dp)
    pd.work_cap = int(full[1][-1]) // 2 - len(pd.win_offs) * n_tiles
    items = pd.backward_items(sk, ek, n_tiles, Dp)
    assert 0 < int(items[1][-1]) < int(full[1][-1])
    assert bool(((items[1] - items[0]) < (full[1] - full[0])).any())
    u = torch.rand((packed.shape[0], 3), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    args = (*items, packed, u, dep_packed, tile)
    want = deposit_lane_bwd_plain(*args, sum_dtype=torch.float64)
    assert float(want.sum()) > 0
    got = deposit_lane_bwd(*args, pd.chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    empty = (items[1] == items[0]).repeat_interleave(pd.chunk)
    assert bool(empty.any()) and float(got[:, empty].abs().sum()) == 0.0


def test_lane_bwd_kernel_repeats_bitwise_at_the_train_size(cuda_device):
    """Kernel #4 on the train path's sizes: no atomics, so two calls agree
    bit for bit, and both agree with the twin summed in float64."""
    pd, packed, dep_packed, sk, ek, n_tiles, Dp, *_ = _lane_round("main", cuda_device)
    items = pd.backward_items(sk, ek, n_tiles, Dp)
    u = torch.rand((packed.shape[0], 3), generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device)
    args = (*items, packed, u, dep_packed, pd.tile)
    a = deposit_lane_bwd(*args, pd.chunk)
    b = deposit_lane_bwd(*args, pd.chunk)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = deposit_lane_bwd_plain(*args, sum_dtype=torch.float64)
    assert float(want.sum()) > 0
    torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5)


def test_lane_kernels_refuse_a_foreign_geometry(cuda_device):
    """Kernel #3 launches with deposit_geometry(tile, 1) and kernel #4 with
    lane_bwd_geometry, each one block a part of its runs; their plans of the
    parts equal run_parts'.  Each refuses any other geometry (threads, shared
    memory), no items a part, a block count other than parts_bound, or a Dp
    that is not n_blocks chunks, with cudaErrorInvalidValue (1)."""
    rng = np.random.default_rng(2)
    tile, n_tiles, K, dp = 96, 3, 4, 2048
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, dp, cuda_device)
    lo, hi, wa, wb = _lane_items(*_ragged_intervals(rng, n_tiles, K, dp, cuda_device),
                                 cuda_device)
    g = deposit_geometry(tile, lane_kernel.LANE_GRID_SPLITS)
    per, W = lane_kernel.LANE_ITEMS_PER_BLOCK, wa.shape[0]
    want_run, want_end = lane_kernel.run_parts(lo, hi, per, W)
    n_parts = lane_kernel.parts_bound(n_tiles, per, W)
    part_run = torch.full((n_parts,), -1, dtype=torch.int32, device=cuda_device)
    part_end = torch.full((n_tiles,), -1, dtype=torch.int32, device=cuda_device)
    out = torch.empty((n_tiles * tile, 8), dtype=torch.float32, device=cuda_device)
    scratch = torch.empty((n_parts, tile, 4), dtype=torch.float32, device=cuda_device)
    launch = lambda threads, splits, smem, n_parts=n_parts, per_=per: \
        lane_kernel.FORWARD.launch(
            cuda_device, ptr(lo), ptr(hi), n_tiles, tile, ptr(wa), ptr(wb), ptr(packed),
            ptr(dep_packed), dp, ptr(out), threads, splits, smem, ptr(scratch), ptr(part_run),
            ptr(part_end), n_parts, W, per_)
    launch(g.threads, g.splits, g.shared_bytes)
    torch.cuda.synchronize()
    assert torch.equal(part_run, want_run) and torch.equal(part_end, want_end)
    _assert_deposit_equal(out, deposit_lane_plain(lo, hi, wa, wb, packed, dep_packed,
                                                  sum_dtype=torch.float64))
    for bad in [dict(threads=g.threads - 1, splits=g.splits, smem=g.shared_bytes),
                dict(threads=g.threads + g.slot_threads, splits=g.splits + 1,
                     smem=g.shared_bytes),
                dict(threads=g.threads, splits=g.splits, smem=g.shared_bytes - 4),
                dict(threads=g.threads, splits=g.splits, smem=g.shared_bytes, per_=0),
                dict(threads=g.threads, splits=g.splits, smem=g.shared_bytes,
                     n_parts=n_parts - 1)]:
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            launch(**bad)

    chunk, n_blocks = 100, 4
    Dp = chunk * n_blocks
    dep_packed = dep_packed[:, :Dp].contiguous()
    u = torch.rand((n_tiles * tile, 3), device=cuda_device)
    items = _bwd_items(rng, n_blocks, chunk, n_tiles, cuda_device)
    gb = lane_kernel.lane_bwd_geometry(tile, chunk)
    per, W = lane_kernel.LANE_BWD_ITEMS_PER_BLOCK, items[2].shape[0]
    want_run, want_end = lane_kernel.run_parts(items[0], items[1], per, W)
    n_parts = lane_kernel.parts_bound(n_blocks, per, W)
    part_run = torch.full((n_parts,), -1, dtype=torch.int32, device=cuda_device)
    part_end = torch.full((n_blocks,), -1, dtype=torch.int32, device=cuda_device)
    d_out = torch.empty((3, Dp), dtype=torch.float32, device=cuda_device)
    scratch = torch.empty((n_parts, 3, chunk), dtype=torch.float32, device=cuda_device)
    bwd = lambda threads, smem, dp_=Dp, n_parts=n_parts, per_=per: \
        lane_kernel.BACKWARD.launch(
            cuda_device, *(ptr(x) for x in items[:2]), n_blocks, chunk,
            *(ptr(x) for x in items[2:]), tile, ptr(packed), ptr(u), ptr(dep_packed), dp_,
            ptr(d_out), threads, smem, ptr(scratch), ptr(part_run), ptr(part_end), n_parts,
            W, per_)
    bwd(gb.threads, gb.shared_bytes)
    torch.cuda.synchronize()
    assert torch.equal(part_run, want_run) and torch.equal(part_end, want_end)
    torch.testing.assert_close(d_out, deposit_lane_bwd_plain(
        *items, packed, u, dep_packed, tile, sum_dtype=torch.float64), rtol=1e-5, atol=1e-5)
    for bad in [dict(threads=gb.threads - 32, smem=gb.shared_bytes),
                dict(threads=gb.threads + 32, smem=gb.shared_bytes),
                dict(threads=gb.threads, smem=gb.shared_bytes - 4),
                dict(threads=gb.threads, smem=gb.shared_bytes + 4),
                dict(threads=gb.threads, smem=gb.shared_bytes, dp_=Dp + chunk),
                dict(threads=gb.threads, smem=gb.shared_bytes, per_=0),
                dict(threads=gb.threads, smem=gb.shared_bytes, n_parts=n_parts + 1)]:
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            bwd(**bad)


@pytest.mark.parametrize("per_block", [1, 2, 3, 7])
def test_lane_plan_equals_run_parts_over_many_runs(cuda_device, per_block):
    """The kernels' one-block plan of the parts (a scan over rounds of 1024
    runs) against run_parts on 5000 runs, ragged and with empty runs: taken
    from kernel #3's launch on empty masks."""
    rng = np.random.default_rng(per_block)
    n = rng.choice([0, 0, 1, 2, 3, 5, 9, 28, 300], 5000)
    hi = np.cumsum(n)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=cuda_device)
    lo, hi = i32(hi - n), i32(hi)
    W = int(hi[-1])
    wa = wb = torch.zeros((W,), dtype=torch.int32, device=cuda_device)
    tile, n_tiles = 32, 5000
    packed, dep_packed = _box_slots_and_lanes(rng, n_tiles * tile, 512, cuda_device)
    g = deposit_geometry(tile, 1)
    n_parts = lane_kernel.parts_bound(n_tiles, per_block, W)
    plan = torch.full((n_parts + n_tiles,), -1, dtype=torch.int32, device=cuda_device)
    out = torch.empty((n_tiles * tile, 8), dtype=torch.float32, device=cuda_device)
    scratch = torch.empty((n_parts, tile, 4), dtype=torch.float32, device=cuda_device)
    lane_kernel.FORWARD.launch(cuda_device, ptr(lo), ptr(hi), n_tiles, tile, ptr(wa), ptr(wb),
                               ptr(packed), ptr(dep_packed), 512, ptr(out), g.threads,
                               g.splits, g.shared_bytes, ptr(scratch), ptr(plan),
                               ptr(plan[n_parts:]), n_parts, W, per_block)
    torch.cuda.synchronize()
    want_run, want_end = lane_kernel.run_parts(lo, hi, per_block, W)
    assert torch.equal(plan[:n_parts], want_run) and torch.equal(plan[n_parts:], want_end)
    assert float(out.abs().sum()) == 0.0


def test_dot_rounds_on_the_card_as_on_the_cpu(cuda_device):
    """``vecmath.dot`` adds x + y + z from the left on both devices, so the
    card's dot products equal the CPU's bit for bit (ROADMAP.md, F3)."""
    from raytrace3_tpu_torch.core.vecmath import dot

    g = torch.Generator().manual_seed(0)
    a, b = (torch.randn((1 << 16, 3), generator=g) * 50 for _ in range(2))
    assert torch.equal(dot(a.to(cuda_device), b.to(cuda_device)).cpu(), dot(a, b))


def test_one_rank_sharded_pass_is_the_pass_on_the_card(cuda_device):
    """On a 1 x 1 mesh (no process group) the sharded pass through the
    Newton and tile kernels equals ``make_pass_fn``'s bit for bit, the
    gather and the ring alike."""
    from raytrace3_tpu_torch.parallel.mesh import make_mesh
    from raytrace3_tpu_torch.parallel.shard import make_sharded_pass_fn
    from raytrace3_tpu_torch.render.driver import (CAMERA_LOOK, CAMERA_POS, build_scene,
                                                   make_pass_fn)
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(scene="full", width=64, height=64, rounds=2, photons_per_round=4096,
                       atlas_res=32, photon_regen=True, hitpoint_factor=2.0,
                       eye_compact_schedule=((1, 0.25), (4, 0.04)))
    scene = build_scene(cfg, cuda_device)
    depo = DepositTile(tile=256, chunk=2048)
    newton = newton_kernel.make_newton(10, 8)
    before = (newton_kernel.KERNEL.launches, deposit_kernel.KERNEL.launches)
    want, _ = make_pass_fn(scene, cfg, CAMERA_POS, CAMERA_LOOK, depo, newton)(
        torch.Generator(device=cuda_device).manual_seed(2))
    for ring in (False, True):
        fn = make_sharded_pass_fn(scene, cfg, CAMERA_POS, CAMERA_LOOK,
                                  make_mesh(device=cuda_device), depo, newton, hp_sharded=ring)
        g = torch.Generator(device=cuda_device).manual_seed(2)
        img, st = fn(g, g)
        assert torch.equal(img, want), ring
        assert int(st["dropped"]) == 0 and int(st["deposits_dropped"]) == 0
    assert newton_kernel.KERNEL.launches > before[0] and deposit_kernel.KERNEL.launches > before[1]
