"""Ray-plane intersection and planar UV mapping.

Port of ``raytrace3_tpu/geometry/plane.py`` (reference ``PlaneObj``,
Obj.h:55-101).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.types import Record
from ..core.vecmath import M_EPS, MAX_DIST, dot, normalize
from ..ops.onehot import pick_columns, take_rows


@dataclass
class Planes(Record):
    p0: torch.Tensor         # (P, 3) a point on each plane
    normal: torch.Tensor     # (P, 3) unit normal, not flipped toward rays
    tex_u_mod: torch.Tensor  # (P,) |texU| = 400
    tex_v_mod: torch.Tensor  # (P,) |texV| = 300

    @property
    def count(self) -> int:
        return self.p0.shape[0]


def make_planes(p0, normal, tex_u_mod=400.0, tex_v_mod=300.0,
                device="cpu") -> Planes:
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    p0 = f32(p0).reshape(-1, 3)
    count = p0.shape[0]
    return Planes(
        p0=p0,
        normal=normalize(f32(normal).reshape(-1, 3)),
        tex_u_mod=f32(tex_u_mod).expand(count).clone(),
        tex_v_mod=f32(tex_v_mod).expand(count).clone(),
    )


def intersect_planes(org: torch.Tensor, dir: torch.Tensor, planes: Planes):
    """All-pairs hits (Obj.h:65-85): a miss when the direction is within
    M_EPS of parallel or the distance is <= M_EPS.

    Returns t (R, P), MAX_DIST on a miss, and hit (R, P).
    """
    proj = dot(dir[:, None, :], planes.normal[None])
    num = dot(planes.p0[None] - org[:, None, :], planes.normal[None])
    safe = torch.where(torch.abs(proj) < M_EPS, 1.0, proj)
    t = num / safe
    hit = (torch.abs(proj) >= M_EPS) & (t > M_EPS)
    return torch.where(hit, t, MAX_DIST), hit


def plane_axis_indices(normal: torch.Tensor):
    """(udex, vdex): the LAST axis with a nonzero normal component is ndir;
    udex = (ndir + 1) % 3, vdex = (ndir + 2) % 3 (Obj.h:89-96)."""
    nz = normal != 0.0
    ndir = torch.where(nz[..., 2], 2, torch.where(nz[..., 1], 1, 0))
    return (ndir + 1) % 3, (ndir + 2) % 3


def plane_uv(pos: torch.Tensor, planes: Planes, plane_idx: torch.Tensor):
    """Planar UV of each ray's plane; u is scaled by |texV| and v by |texU|
    (the reference's swapped scales, Obj.h:97-98)."""
    n = take_rows(planes.normal, plane_idx)
    udex, vdex = plane_axis_indices(n)
    d = pos - take_rows(planes.p0, plane_idx)
    v = 0.5 + pick_columns(d, vdex) / take_rows(planes.tex_u_mod, plane_idx)
    u = 0.5 + pick_columns(d, udex) / take_rows(planes.tex_v_mod, plane_idx)
    return u, v
