"""The all-pairs deposit with a recomputing backward.

Port of ``raytrace3_tpu/diff/vjp.py:deposit_bruteforce_vjp``.  Plain
autograd through the chunked all-pairs deposit would save every chunk's
(C x J) neighbour mask, the whole C x D matrix; this Function saves only
its inputs and the (C, 3) flux row sums and rebuilds each mask chunk in
the backward.

Gradient semantics: the neighbour mask is a box kernel, piecewise constant
in positions, normals and radii, so its derivative is zero almost
everywhere and gradients reach only ``hp.wgt`` and ``dep.flux``
(Raytracer.h:156 is the line differentiated).
"""

from __future__ import annotations

import math

import torch

from ..core.types import Deposits, HitPoints
from ..render.deposit import NORMAL_DOT_MIN, pair_d2_ndot


def _mask(hp_pos, hp_n, hp_r2, hp_valid, d_pos, d_n, d_valid) -> torch.Tensor:
    d2, ndot = pair_d2_ndot(hp_pos, hp_n, d_pos, d_n)
    m = ((d2 <= hp_r2[:, None]) & (ndot > NORMAL_DOT_MIN)
         & d_valid[None, :] & hp_valid[:, None])
    return m.to(d_pos.dtype)


class _BruteforceDeposit(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hp_pos, hp_n, hp_r2, hp_valid, wgt, d_pos, d_n, flux,
                d_valid, chunk):
        C = hp_pos.shape[0]
        cnt = torch.zeros((C,), dtype=d_pos.dtype, device=d_pos.device)
        fl = torch.zeros((C, 3), dtype=d_pos.dtype, device=d_pos.device)
        for a in range(0, d_pos.shape[0], chunk):
            sl = slice(a, a + chunk)
            m = _mask(hp_pos, hp_n, hp_r2, hp_valid, d_pos[sl], d_n[sl], d_valid[sl])
            cnt = cnt + m.sum(1)
            fl = fl + m @ flux[sl]
        ctx.chunk = chunk
        ctx.mark_non_differentiable(cnt)
        ctx.save_for_backward(hp_pos, hp_n, hp_r2, hp_valid, wgt, d_pos, d_n,
                              d_valid, fl)
        return cnt, wgt * fl / math.pi

    @staticmethod
    def backward(ctx, _g_cnt, g_tao):
        hp_pos, hp_n, hp_r2, hp_valid, wgt, d_pos, d_n, d_valid, fl = ctx.saved_tensors
        d_wgt = g_tao * fl / math.pi
        gw = g_tao * wgt / math.pi                                 # (C, 3)
        parts = []
        for a in range(0, d_pos.shape[0], ctx.chunk):
            sl = slice(a, a + ctx.chunk)
            m = _mask(hp_pos, hp_n, hp_r2, hp_valid, d_pos[sl], d_n[sl], d_valid[sl])
            parts.append(m.T @ gw)                                 # (chunk, 3)
        d_flux = torch.cat(parts, 0) if parts else torch.zeros_like(d_pos)
        return (None, None, None, None, d_wgt, None, None, d_flux, None, None)


def deposit_bruteforce_vjp(hp: HitPoints, dep: Deposits, chunk: int = 4096):
    """Drop-in for ``render.deposit.deposit_bruteforce`` with O(C + D)
    memory on the backward pass: (d_nphot (C,), d_tao (C, 3))."""
    return _BruteforceDeposit.apply(hp.pos, hp.n, hp.r2, hp.valid, hp.wgt,
                                    dep.pos, dep.n, dep.flux, dep.valid, chunk)
