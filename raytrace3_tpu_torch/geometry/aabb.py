"""Axis-aligned bounding boxes: the branchless slab test.

Port of ``raytrace3_tpu/geometry/aabb.py``.
"""

from __future__ import annotations

import torch


def aabb_from_points(points: torch.Tensor):
    """(..., K, 3) points -> (pmin, pmax), each (..., 3)."""
    return points.amin(-2), points.amax(-2)


def slab_test(org: torch.Tensor, dir: torch.Tensor, pmin: torch.Tensor,
              pmax: torch.Tensor, t_eps: float = 0.0) -> torch.Tensor:
    """True where the ray meets the box at some t >= t_eps.

    Zero direction components give +-inf slabs (IEEE); a NaN slab (0 * inf,
    origin exactly on a face) is opened rather than propagated.
    """
    inv = 1.0 / dir
    t0 = (pmin - org) * inv
    t1 = (pmax - org) * inv
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    tnear = torch.where(torch.isnan(tnear), -torch.inf, tnear)
    tfar = torch.where(torch.isnan(tfar), torch.inf, tfar)
    return tfar >= torch.clamp_min(tnear, t_eps)
