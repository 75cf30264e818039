"""Flux deposit oracle: the exact all-pairs accumulation.

Port of ``raytrace3_tpu/render/deposit.py``'s ``deposit_bruteforce``, the
O(C x D) oracle the banded deposits are held against (reference neighbour
filter, Raytracer.h:154-157), with its two density kernels: the reference's
box and the smooth Epanechnikov kernel of the geometry-gradient path
(:func:`deposit_bruteforce_epa`).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

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


def _chunk_contrib(hp_pos, hp_n, hp_r2, hp_valid, dp, dn, df, dv, kernel: str):
    """One deposit chunk's (count (C,), flux (C, 3)) for every hit point,
    the flux before the wgt / pi factor.

    ``kernel``: "box", the reference's uniform disc (weight 1), or
    "epanechnikov", weight 2 (1 - d2 / r2): it integrates to 1 over the
    disc as the box does, and is continuous at the radius, so its autograd
    derivatives with respect to positions and r2 are the estimator's own.
    The count stays box-counted under both (it drives the radius shrink).
    """
    d2, ndot = pair_d2_ndot(hp_pos, hp_n, dp, dn)
    mask = ((d2 <= hp_r2[:, None]) & (ndot > NORMAL_DOT_MIN)
            & dv[None, :] & hp_valid[:, None])
    w = mask.to(dp.dtype)
    if kernel == "epanechnikov":
        r2s = torch.where(hp_r2 > 0, hp_r2, 1.0)
        wf = w * 2.0 * (1.0 - d2 / r2s[:, None])
    elif kernel == "box":
        wf = w
    else:
        raise ValueError(f"unknown deposit kernel: {kernel}")
    return w.sum(1), wf @ df


def deposit_bruteforce(hp: HitPoints, dep: Deposits, chunk: int = 4096,
                       kernel: str = "box"):
    """All-pairs deposit, chunked over deposits.

    Returns d_nphot (C,) photon count increments and d_tao (C, 3) flux
    increments ``wgt * sum(k_w * flux) / pi`` (Raytracer.h:156), k_w the
    ``kernel``'s weight (:func:`_chunk_contrib`).  Each chunk runs under
    activation checkpointing, as JAX's under ``jax.checkpoint``
    (deposit.py:123-128): a backward recomputes its (C, chunk) pair
    matrices instead of keeping them all alive.
    """
    cnt = torch.zeros((hp.capacity,), dtype=dep.pos.dtype, device=dep.pos.device)
    fl = torch.zeros((hp.capacity, 3), dtype=dep.pos.dtype, device=dep.pos.device)
    for a in range(0, dep.pos.shape[0], chunk):
        sl = slice(a, a + chunk)
        dc, dfl = checkpoint(_chunk_contrib, hp.pos, hp.n, hp.r2, hp.valid, dep.pos[sl],
                             dep.n[sl], dep.flux[sl], dep.valid[sl], kernel,
                             use_reentrant=False, preserve_rng_state=False)
        cnt = cnt + dc
        fl = fl + dfl
    return cnt, hp.wgt * fl / math.pi


def deposit_bruteforce_epa(hp: HitPoints, dep: Deposits, chunk: int = 4096):
    """The Epanechnikov-kernel bruteforce deposit, the opt-in estimator of
    geometry gradients (``kernel="epanechnikov"``)."""
    return deposit_bruteforce(hp, dep, chunk=chunk, kernel="epanechnikov")
