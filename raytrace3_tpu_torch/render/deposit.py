"""Flux deposit oracle: the exact all-pairs accumulation.

Port of ``raytrace3_tpu/render/deposit.py``'s box-kernel
``deposit_bruteforce``, the O(C x D) oracle the banded deposit is held
against (reference neighbour filter, Raytracer.h:154-157).
"""

from __future__ import annotations

import math

import torch

from ..core.types import Deposits, HitPoints

#: Normal-agreement threshold (Raytracer.h:154).
NORMAL_DOT_MIN = 1e-3


def pair_d2_ndot(hp_pos, hp_n, dp, dn):
    """Exact pairwise |h - d|^2 and n_h . n_d, (C, J), by broadcast."""
    d2 = ((hp_pos[:, 0, None] - dp[None, :, 0]) ** 2
          + (hp_pos[:, 1, None] - dp[None, :, 1]) ** 2
          + (hp_pos[:, 2, None] - dp[None, :, 2]) ** 2)
    ndot = (hp_n[:, 0, None] * dn[None, :, 0]
            + hp_n[:, 1, None] * dn[None, :, 1]
            + hp_n[:, 2, None] * dn[None, :, 2])
    return d2, ndot


def deposit_bruteforce(hp: HitPoints, dep: Deposits, chunk: int = 4096):
    """All-pairs deposit, chunked over deposits.

    Returns d_nphot (C,) photon count increments and d_tao (C, 3) flux
    increments ``wgt * sum(flux) / pi`` (Raytracer.h:156).
    """
    cnt = torch.zeros((hp.capacity,), dtype=dep.pos.dtype, device=dep.pos.device)
    fl = torch.zeros((hp.capacity, 3), dtype=dep.pos.dtype, device=dep.pos.device)
    for a in range(0, dep.pos.shape[0], chunk):
        sl = slice(a, a + chunk)
        d2, ndot = pair_d2_ndot(hp.pos, hp.n, dep.pos[sl], dep.n[sl])
        mask = ((d2 <= hp.r2[:, None]) & (ndot > NORMAL_DOT_MIN)
                & dep.valid[sl][None, :] & hp.valid[:, None])
        w = mask.to(dep.pos.dtype)
        cnt = cnt + w.sum(1)
        fl = fl + w @ dep.flux[sl]
    return cnt, hp.wgt * fl / math.pi
