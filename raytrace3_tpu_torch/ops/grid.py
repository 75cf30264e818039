"""Uniform-grid photon deposit, the CLI's ``--deposit grid``.

Port of ``raytrace3_tpu/ops/grid.py`` (the reference's kd-tree radius
search, Raytracer.h:92-98, 144-159, 370-381, inverted): each round the
deposits are sorted by grid cell, and every hit point gathers from the
windows of its 27 neighbouring cells, at most ``max_per_cell`` deposits per
cell.  The cell side is the global search radius, so every neighbour lies
in the 3 x 3 x 3 block; the exact d^2 <= r2 and normal tests remain the
filter.  Deposits beyond ``max_per_cell`` in their cell are invisible to
every window and counted: the backend ``returns_aux``, and its third
return value, the overflow count, goes into ``deposits_dropped``.  Plain
PyTorch, no kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import Deposits, HitPoints
from ..render.deposit import NORMAL_DOT_MIN

#: World bounds covering the reference scene (Scene.h:116-154).
DEFAULT_LO = (-20.0, -20.0, -20.0)
DEFAULT_HI = (120.0, 120.0, 180.0)


def make_grid_deposit(lo=DEFAULT_LO, hi=DEFAULT_HI, cell: float = math.sqrt(2.0),
                      max_per_cell: int = 64):
    """``deposit_fn(hp, dep) -> (d_nphot, d_tao, overflow)`` over the grid."""
    lo32 = np.asarray(lo, np.float32)
    hi32 = np.asarray(hi, np.float32)
    nx, ny, nz = (int(x) for x in np.ceil((hi32 - lo32) / np.float32(cell)))
    n_cells = nx * ny * nz

    def deposit_fn(hp: HitPoints, dep: Deposits):
        dev = hp.pos.device
        lo_t = torch.as_tensor(lo32, device=dev)
        top = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32, device=dev)
        dims = top + 1
        coords = lambda p: torch.clamp(torch.floor((p - lo_t) / cell).to(torch.int32),
                                       torch.zeros_like(top), top)
        cell_id = lambda c: c[..., 0] + nx * (c[..., 1] + ny * c[..., 2])

        D = dep.pos.shape[0]
        # Invalid deposits go to the sentinel cell n_cells, sorted last.
        dcell = torch.where(dep.valid, cell_id(coords(dep.pos)), n_cells)
        dcell_s, order = torch.sort(dcell, stable=True)
        dpos, dn, dflux = dep.pos[order], dep.n[order], dep.flux[order]
        starts = torch.searchsorted(dcell_s, torch.arange(n_cells + 1, device=dev,
                                                          dtype=dcell_s.dtype))
        counts = starts[1:] - starts[:-1]
        overflow = torch.clamp_min(counts - max_per_cell, 0).sum().to(torch.int32)

        hcell = coords(hp.pos)                                   # (C, 3)
        win = torch.arange(max_per_cell, device=dev)
        cnt = torch.zeros((hp.capacity,), dtype=dep.pos.dtype, device=dev)
        fl = torch.zeros((hp.capacity, 3), dtype=dep.pos.dtype, device=dev)
        r = torch.arange(-1, 2, device=dev, dtype=torch.int32)
        offsets = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
        for offset in offsets:
            nb = hcell + offset
            inb = ((nb >= 0) & (nb < dims)).all(-1)
            nbid = torch.clamp(cell_id(nb), 0, n_cells - 1).long()
            s, e = starts[nbid], starts[nbid + 1]
            idx = s[:, None] + win[None, :]                      # (C, M)
            m = (idx < e[:, None]) & inb[:, None]
            idx = torch.clamp_max(idx, D - 1)
            d2 = ((dpos[idx] - hp.pos[:, None, :]) ** 2).sum(-1)
            ndot = (dn[idx] * hp.n[:, None, :]).sum(-1)
            ok = (m & (d2 <= hp.r2[:, None]) & (ndot > NORMAL_DOT_MIN)
                  & hp.valid[:, None])
            w = ok.to(dflux.dtype)
            cnt = cnt + w.sum(-1)
            fl = fl + (w[..., None] * dflux[idx]).sum(1)
        return cnt, hp.wgt * fl / math.pi, overflow               # Raytracer.h:156

    deposit_fn.returns_aux = True
    return deposit_fn
