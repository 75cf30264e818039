"""Closed-form batched 3 x 3 linear solve (Cramer's rule).

Port of ``raytrace3_tpu/ops/solve3.py`` (the reference inverts a
``cv::Matx33d`` in its Newton loop, Bezier.h:126-130).  The Newton kernel
inlines the same solve; here it serves ``geometry.bezier.winner_root``'s
implicit-function-theorem backward.
"""

from __future__ import annotations

import torch

from ..core.vecmath import cross, dot


def solve3_columns(c0, c1, c2, r, det_eps: float = 1e-12):
    """Solve ``[c0 | c1 | c2] x = r`` for batched 3-vectors.

    Returns (x0, x1, x2, ok): ok flags |det| > det_eps, and x is zero on
    singular lanes.
    """
    c12 = cross(c1, c2)
    det = dot(c0, c12)
    ok = det.abs() > det_eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    x0 = dot(r, c12) * inv_det
    x1 = dot(c0, cross(r, c2)) * inv_det
    x2 = dot(c0, cross(c1, r)) * inv_det
    return x0, x1, x2, ok
