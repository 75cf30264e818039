"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; the repository's conftest imports JAX, so on such a machine run
it with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels are built with -fmad=false and evaluate in the
plain twins' operation order, so Newton outputs and deposit counts agree
exactly; deposit flux sums differ only in summation order (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

from raytrace3_tpu_torch.core.types import Deposits, HitPoints
from raytrace3_tpu_torch.ops import deposit_kernel, newton_kernel
from raytrace3_tpu_torch.ops.deposit_kernel import (DepositTile, deposit_tile,
                                                    deposit_tile_plain)
from raytrace3_tpu_torch.ops.newton_kernel import solve, solve_plain
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
