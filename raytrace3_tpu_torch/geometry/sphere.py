"""Ray-sphere intersection and spherical-polar UV.

Port of ``raytrace3_tpu/geometry/sphere.py`` (reference ``SphereObj``,
Obj.h:102-154).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.types import Record
from ..core.vecmath import M_EPS, MAX_DIST, cross, dot, normalize
from ..ops.onehot import take_rows


@dataclass
class Spheres(Record):
    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    tex_u: torch.Tensor   # (3,) pole axes of the UV map (Obj.h:107)
    tex_v: torch.Tensor   # (3,)

    @property
    def count(self) -> int:
        return self.center.shape[0]


def make_spheres(center, radius, device="cpu") -> Spheres:
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return Spheres(
        center=f32(center).reshape(-1, 3),
        radius=f32(radius).reshape(-1),
        tex_u=normalize(f32([0.0, 3.0, -3.0])),
        tex_v=f32([1.0, 0.0, 0.0]),
    )


def intersect_spheres(org: torch.Tensor, dir: torch.Tensor, spheres: Spheres):
    """All-pairs hits (Obj.h:111-139): the near root when > M_EPS, else the
    far one; ``inside`` = the near root was rejected.

    Returns t (R, S), hit (R, S), inside (R, S).
    """
    L = spheres.center[None, :, :] - org[:, None, :]          # (R, S, 3)
    proj = dot(L, dir[:, None, :])
    det2 = spheres.radius[None, :] ** 2 - (dot(L, L) - proj * proj)
    miss = det2 < M_EPS
    det = torch.sqrt(torch.where(miss, 1.0, det2))
    d1 = proj - det
    d2 = proj + det
    inside = d1 < M_EPS
    t = torch.where(inside, d2, d1)
    hit = ~miss & (d2 >= M_EPS)
    return torch.where(hit, t, MAX_DIST), hit, inside


def sphere_uv(pos: torch.Tensor, spheres: Spheres, sphere_idx: torch.Tensor):
    """Spherical UV at the hit (Obj.h:140-153)."""
    n = normalize(pos - take_rows(spheres.center, sphere_idx))
    lim = 1.0 - 1e-6
    ct = torch.clamp(dot(n, spheres.tex_v), -lim, lim)
    theta = torch.acos(ct)
    st = torch.sin(theta)
    t = dot(n, spheres.tex_u) / torch.where(st < 1e-12, 1e-12, st)
    phi = torch.acos(torch.clamp(t, -lim, lim))
    u = theta / math.pi
    v = phi / (2.0 * math.pi)
    flip = dot(n, cross(spheres.tex_u, spheres.tex_v)) < 0.0
    return u, torch.where(flip, 1.0 - v, v)
