"""The reference scene, built on a device.

Port of the parts of ``raytrace3_tpu/scenes.py`` that the main path uses:
the ``full`` scene (the reference's exact object list, Scene.h:116-157) and
the helpers it is made of.  The asset-texture override
(``RT3_ASSET_TEXTURES``) and the other scenes wait for a later slice.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device
from .core.types import Materials
from .geometry.bezier import BezierObject, load_bpt, teapot_transform
from .geometry.plane import make_planes
from .geometry.scene import Scene
from .geometry.sphere import make_spheres
from .render.camera import Camera, look_at
from .textures import texture as tx

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

# Reference materials (Scene.h:100-113).
WHITE_DIFF = dict(diff=(0.75, 0.75, 0.75), refl=(0, 0, 0), refr=(0, 0, 0), refrn=0.0)
MIRROR = dict(diff=(0, 0, 0), refl=(0.999, 0.999, 0.999), refr=(0, 0, 0), refrn=0.0)
REFR0 = dict(diff=(0, 0, 0), refl=(0, 0, 0), refr=(0.999, 0.999, 0.999), refrn=1.5)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _materials(mats: list[dict], device="cpu") -> Materials:
    f = lambda k: _f32([m[k] for m in mats], device)
    return Materials(
        diff=f("diff"), refl=f("refl"), refr=f("refr"),
        refrn=_f32([m.get("refrn", 1.5) for m in mats], device),
        refln=_f32([m.get("refln", 1.0) for m in mats], device),
    )


def _atlas(res: int, device="cpu") -> torch.Tensor:
    """Procedural stand-ins for wall / timg / planet / blue (Scene.h:131-156)."""
    return tx.build_atlas([
        tx.bricks(res),                        # 0: wall
        tx.marble(res),                        # 1: timg (floor)
        tx.planet(res),                        # 2: planet
        tx.flat(res, (0.2, 0.35, 0.9)),        # 3: blue
    ], device)


def _cornell_geometry(device="cpu"):
    """The 5 reference planes and 3 reference spheres (Scene.h:116-126)."""
    planes = make_planes(
        p0=[(1, 40.8, 81.6), (99, 40.8, 81.6), (50, 40.8, 0.0),
            (50, 0.0, 81.6), (50, 81.6, 81.6)],
        normal=[(1, 0, 0), (1, 0, 0), (0, 0, 1), (0, -1, 0), (0, 1, 0)],
        device=device,
    )
    spheres = make_spheres(
        center=[(27, 16.5, 47), (73, 16.5, 88), (50, 8.5, 60)],
        radius=[16.5, 16.5, 8.5],
        device=device,
    )
    return planes, spheres


def _teapot_ctrl(device="cpu") -> torch.Tensor:
    """Teapot control points: scale 4, Trans2 @ Trans, translation
    (20, 0, 120) (Scene.h:142-153)."""
    ctrl = load_bpt(os.path.join(ASSETS, "teapot.bpt"), scale=4.0,
                    transform=teapot_transform(), translate=(20.0, 0.0, 120.0))
    return torch.as_tensor(ctrl, device=device)


def reference_camera(width: int = 1024, height: int = 1024,
                     device=DEFAULT_DEVICE) -> Camera:
    """The main.cpp:22-27 pose: (50, 35, 230) looking along (0, 0.042612, -1)."""
    device = resolve_device(device)
    pos = np.array([50.0, 35.0, 230.0])
    return look_at(_f32(pos, device), _f32(pos + np.array([0.0, 0.042612, -1.0]), device),
                   width, height)


def full(atlas_res: int = 256, bezier_uv_quirk: bool = True,
         device=DEFAULT_DEVICE) -> Scene:
    """The reference's object list: ids 0-4 planes, 5 mirror sphere, 6 glass
    sphere, 7 planet sphere, 8 teapot."""
    device = resolve_device(device)
    planes, spheres = _cornell_geometry(device)
    mats = [WHITE_DIFF, WHITE_DIFF, MIRROR, WHITE_DIFF, WHITE_DIFF,
            MIRROR, REFR0, WHITE_DIFF, WHITE_DIFF]
    color = _f32(
        [(0.75, 0.25, 0.25), (0.25, 0.25, 0.75), (0.75, 0.75, 0.75),
         (0.75, 0.75, 0.75), (0.75, 0.75, 0.75),
         (0.999,) * 3, (0.999,) * 3, (0.999,) * 3,
         (0.0, 0.999, 0.999)], device)
    return Scene(
        planes=planes, spheres=spheres,
        bezier=BezierObject(ctrl=_teapot_ctrl(device)),
        materials=_materials(mats, device), obj_color=color,
        obj_tex=torch.as_tensor([0, 0, -1, 1, 0, -1, -1, 2, 3],
                                dtype=torch.int32, device=device),
        atlas=_atlas(atlas_res, device),
        light_pos=_f32([[50.0, 60.0, 85.0]], device),
        light_color=_f32([[5000.0] * 3], device),
        bezier_uv_quirk=bezier_uv_quirk,
    )


REGISTRY = {"full": full}


def get_scene(name: str, device=DEFAULT_DEVICE, **kw) -> Scene:
    if name not in REGISTRY:
        raise KeyError(f"scene '{name}' is not ported yet; have {sorted(REGISTRY)}")
    return REGISTRY[name](device=device, **kw)
