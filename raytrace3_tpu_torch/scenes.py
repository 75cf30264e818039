"""The named scenes, built on a device.

Port of ``raytrace3_tpu/scenes.py``'s registry:

  * ``cornell_diffuse``    -- spheres and planes, diffuse only, flat colours;
  * ``cornell_specular``   -- textured walls, mirror back wall, mirror and
    glass spheres;
  * ``bezier_patch``       -- one bicubic teapot patch with a UV texture;
  * ``cornell_two_lights`` -- ``cornell_diffuse`` with two lights;
  * ``full`` (= ``teapot``) -- the reference's exact object list
    (Scene.h:116-157);
  * ``full_flat``          -- ``full`` with every texture off.

The atlas holds procedural stand-ins for the reference's textures.  When
the environment variable ``RT3_ASSET_TEXTURES`` (or ``_atlas``'s
``asset_dir``) names a directory, each slot whose file is there (``wall``,
``timg``, ``planet``, ``blue`` with ``.jpg``, ``.jpeg`` or ``.png``) is read
from it instead, as the JAX package does; reading needs PIL, and without
it the override raises ``ImportError``.
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
RED_DIFF = dict(diff=(0.75, 0.3, 0.3), refl=(0, 0, 0), refr=(0, 0, 0), refrn=0.0)
BLUE_DIFF = dict(diff=(0.3, 0.3, 0.75), refl=(0, 0, 0), refr=(0, 0, 0), refrn=0.0)
#: The flat colours of the Cornell objects, planes then spheres.
CORNELL_COLOR = [(0.75, 0.25, 0.25), (0.25, 0.25, 0.75), (0.75, 0.75, 0.75),
                 (0.75, 0.75, 0.75), (0.75, 0.75, 0.75),
                 (0.999,) * 3, (0.999,) * 3, (0.999,) * 3]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _materials(mats: list[dict], device="cpu") -> Materials:
    f = lambda k: _f32([m[k] for m in mats], device)
    return Materials(
        diff=f("diff"), refl=f("refl"), refr=f("refr"),
        refrn=_f32([m.get("refrn", 1.5) for m in mats], device),
        refln=_f32([m.get("refln", 1.0) for m in mats], device),
    )


#: Atlas slot -> reference asset file stem (Scene.h:131-156); extensions
#: are tried in this order.
ATLAS_ASSETS = ("wall", "timg", "planet", "blue")
_ASSET_EXTS = (".jpg", ".jpeg", ".png")


def _atlas(res: int, device="cpu", asset_dir: str | None = None) -> torch.Tensor:
    """Procedural stand-ins for wall / timg / planet / blue (Scene.h:131-156).

    When ``asset_dir`` (or, if it is None, ``RT3_ASSET_TEXTURES``) names a
    directory, each slot with a file there is read with
    ``textures.texture.load_image``; a slot without one stays procedural."""
    slots = [
        tx.bricks(res),                        # 0: wall
        tx.marble(res),                        # 1: timg (floor)
        tx.planet(res),                        # 2: planet
        tx.flat(res, (0.2, 0.35, 0.9)),        # 3: blue
    ]
    asset_dir = asset_dir or os.environ.get("RT3_ASSET_TEXTURES")
    if asset_dir:
        for i, stem in enumerate(ATLAS_ASSETS):
            for ext in _ASSET_EXTS:
                path = os.path.join(asset_dir, stem + ext)
                if os.path.exists(path):
                    slots[i] = tx.load_image(path, res)
                    break
    return tx.build_atlas(slots, device)


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


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _one_light(device):
    return dict(light_pos=_f32([[50.0, 60.0, 85.0]], device),
                light_color=_f32([[5000.0] * 3], device))


def cornell_diffuse(atlas_res: int = 64, device=DEFAULT_DEVICE) -> Scene:
    """All-diffuse Cornell spheres and planes, flat colours."""
    device = resolve_device(device)
    planes, spheres = _cornell_geometry(device)
    mats = [RED_DIFF, BLUE_DIFF] + [WHITE_DIFF] * 6
    return Scene(
        planes=planes, spheres=spheres, bezier=None,
        materials=_materials(mats, device), obj_color=_f32(CORNELL_COLOR, device),
        obj_tex=_i32([-1] * 8, device), atlas=_atlas(atlas_res, device),
        **_one_light(device))


def cornell_specular(atlas_res: int = 128, device=DEFAULT_DEVICE) -> Scene:
    """The reference scene without the teapot: textured walls, mirror back
    plane, mirror and glass spheres (Scene.h:116-141, 157)."""
    device = resolve_device(device)
    planes, spheres = _cornell_geometry(device)
    mats = [WHITE_DIFF, WHITE_DIFF, MIRROR, WHITE_DIFF, WHITE_DIFF,
            MIRROR, REFR0, WHITE_DIFF]
    return Scene(
        planes=planes, spheres=spheres, bezier=None,
        materials=_materials(mats, device), obj_color=_f32(CORNELL_COLOR, device),
        obj_tex=_i32([0, 0, -1, 1, 0, -1, -1, 2], device),
        atlas=_atlas(atlas_res, device), **_one_light(device))


def bezier_patch(atlas_res: int = 128, device=DEFAULT_DEVICE) -> Scene:
    """One bicubic patch (teapot body quarter 4) with the planet texture
    over the marble floor, the rest white."""
    device = resolve_device(device)
    planes, spheres = _cornell_geometry(device)
    color = torch.cat([torch.full((8, 3), 0.75, dtype=torch.float32, device=device),
                       _f32([[0.0, 0.999, 0.999]], device)])
    return Scene(
        planes=planes, spheres=spheres,
        bezier=BezierObject(ctrl=_teapot_ctrl(device)[4:5]),
        materials=_materials([WHITE_DIFF] * 9, device), obj_color=color,
        obj_tex=_i32([-1, -1, -1, 1, -1, -1, -1, -1, 2], device),
        atlas=_atlas(atlas_res, device), **_one_light(device))


def full(atlas_res: int = 256, bezier_uv_quirk: bool = True,
         device=DEFAULT_DEVICE) -> Scene:
    """The reference's object list: ids 0-4 planes, 5 mirror sphere, 6 glass
    sphere, 7 planet sphere, 8 teapot."""
    device = resolve_device(device)
    planes, spheres = _cornell_geometry(device)
    mats = [WHITE_DIFF, WHITE_DIFF, MIRROR, WHITE_DIFF, WHITE_DIFF,
            MIRROR, REFR0, WHITE_DIFF, WHITE_DIFF]
    return Scene(
        planes=planes, spheres=spheres,
        bezier=BezierObject(ctrl=_teapot_ctrl(device)),
        materials=_materials(mats, device),
        obj_color=_f32(CORNELL_COLOR + [(0.0, 0.999, 0.999)], device),
        obj_tex=_i32([0, 0, -1, 1, 0, -1, -1, 2, 3], device),
        atlas=_atlas(atlas_res, device), bezier_uv_quirk=bezier_uv_quirk,
        **_one_light(device))


def cornell_two_lights(atlas_res: int = 64, device=DEFAULT_DEVICE) -> Scene:
    """``cornell_diffuse`` lit by two lights of different position and power
    (the reference's older two-spotlight scene, Scene.h:44-68)."""
    s = cornell_diffuse(atlas_res, device)
    return s.replace(
        light_pos=_f32([[50.0, 60.0, 85.0], [30.0, 50.0, 120.0]], s.device),
        light_color=_f32([[2500.0] * 3, [1000.0, 2000.0, 2000.0]], s.device))


def full_flat(atlas_res: int = 16, bezier_uv_quirk: bool = True,
              device=DEFAULT_DEVICE) -> Scene:
    """``full`` with every texture off (each object its flat colour): the
    scene the C++ oracle ``native/baseline_sppm.cpp`` renders."""
    s = full(atlas_res, bezier_uv_quirk, device)
    return s.replace(obj_tex=_i32([-1] * 9, s.device))


teapot = full

REGISTRY = {
    "full_flat": full_flat,
    "cornell_two_lights": cornell_two_lights,
    "cornell_diffuse": cornell_diffuse,
    "cornell_specular": cornell_specular,
    "bezier_patch": bezier_patch,
    "teapot": teapot,
    "full": full,
}


def get_scene(name: str, device=DEFAULT_DEVICE, **kw) -> Scene:
    if name not in REGISTRY:
        raise KeyError(f"unknown scene '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name](device=device, **kw)
