"""Scene record and the fused nearest hit over all primitives.

Port of ``raytrace3_tpu/geometry/scene.py`` (reference ``Scene``,
Scene.h:93-183).  Object ids: planes [0, P), spheres [P, P+S), the Bezier
object P+S.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.types import HitRecord, Materials, Record
from ..core.vecmath import MAX_DIST, normalize
from ..ops.onehot import pick_columns, take_rows
from ..textures.texture import sample_atlas
from .bezier import BezierObject, intersect_bezier
from .plane import Planes, intersect_planes, plane_uv
from .sphere import Spheres, intersect_spheres, sphere_uv


@dataclass
class Scene(Record):
    planes: Planes
    spheres: Spheres
    bezier: BezierObject | None      # None when the scene has no patches
    materials: Materials             # (N,) object-major tables
    obj_color: torch.Tensor          # (N, 3) flat colour
    obj_tex: torch.Tensor            # (N,) int32 atlas id, -1 = flat colour
    atlas: torch.Tensor              # (T, H, W, 3)
    light_pos: torch.Tensor          # (L, 3)
    light_color: torch.Tensor        # (L, 3)
    #: Reference quirk #1 (Bezier.h:278): the teapot texture lookup uses
    #: (u, ray distance t) instead of (u, v).
    bezier_uv_quirk: bool = True
    #: Fraction of rays gathered through the object-AABB compaction before
    #: the Newton solve (1.0 = dense).
    bezier_compact_frac: float = 1.0
    #: The default solver's budget (``geometry.bezier.solve_winner``):
    #: Newton iterations and the side of its stratified restart grid
    #: (reference: 10 iterations x 50 random restarts, Bezier.h:6, 115).
    #: A solver passed as ``newton_fn`` carries its own.
    newton_iters: int = 10
    newton_restarts: int = 4

    @property
    def n_planes(self) -> int:
        return self.planes.count

    @property
    def n_spheres(self) -> int:
        return self.spheres.count

    @property
    def has_bezier(self) -> bool:
        return self.bezier is not None

    @property
    def n_objects(self) -> int:
        return self.n_planes + self.n_spheres + (1 if self.has_bezier else 0)

    @property
    def device(self) -> torch.device:
        return self.atlas.device


def intersect_scene(scene: Scene, org: torch.Tensor, dir: torch.Tensor,
                    newton_fn=None) -> HitRecord:
    """Nearest hit for a batch of rays (R, 3) (Scene.h:165-182), with the
    colour and normal resolved for the winning object only."""
    P, S = scene.n_planes, scene.n_spheres

    tp, _ = intersect_planes(org, dir, scene.planes)          # (R, P)
    ts, _, ins_s = intersect_spheres(org, dir, scene.spheres)  # (R, S)
    parts = [tp, ts]
    if scene.has_bezier:
        tb, hb, ub, vb, nb = intersect_bezier(
            org, dir, scene.bezier, iters=scene.newton_iters,
            restarts=scene.newton_restarts, newton_fn=newton_fn,
            compact_frac=scene.bezier_compact_frac)
        parts.append(torch.where(hb, tb, MAX_DIST)[:, None])
    t_all = torch.cat(parts, 1)                                # (R, N)

    obj = torch.argmin(t_all, 1).to(torch.int32)               # first minimum
    t = t_all.amin(1)
    hit = t < MAX_DIST
    obj_id = torch.where(hit, obj, -1).to(torch.int32)
    # Clamp the sentinel distance before forming positions.
    pos = org + torch.clamp_max(t, 1e6)[:, None] * dir

    is_plane = obj < P
    is_sphere = (obj >= P) & (obj < P + S)
    pi = torch.clamp(obj, 0, P - 1)
    si = torch.clamp(obj - P, 0, S - 1)

    # Planes keep the stored normal, spheres the outward one, Bezier the
    # viewer-facing patch normal.
    n = take_rows(scene.planes.normal, pi)
    n = torch.where(is_sphere[:, None],
                    normalize(pos - take_rows(scene.spheres.center, si)), n)
    if scene.has_bezier:
        n = torch.where((~is_plane & ~is_sphere)[:, None], nb, n)

    inside = is_sphere & pick_columns(ins_s, si)

    up, vp = plane_uv(pos, scene.planes, pi)
    us, vs = sphere_uv(pos, scene.spheres, si)
    u = torch.where(is_sphere, us, up)
    v = torch.where(is_sphere, vs, vp)
    if scene.has_bezier:
        bmask = ~is_plane & ~is_sphere
        u = torch.where(bmask, ub, u)
        v = torch.where(bmask, t if scene.bezier_uv_quirk else vb, v)

    obj_c = torch.clamp(obj, 0, scene.n_objects - 1)
    tex_id = take_rows(scene.obj_tex, obj_c)
    tex_col = sample_atlas(scene.atlas, tex_id, u, v)
    color = torch.where((tex_id >= 0)[:, None], tex_col,
                        take_rows(scene.obj_color, obj_c))
    return HitRecord(t=t, hit=hit, pos=pos, n=n, inside=inside,
                     obj_id=obj_id, color=color)
