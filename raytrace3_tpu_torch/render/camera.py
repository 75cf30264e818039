"""Pinhole camera: basis construction and pixel-grid ray generation.

Port of ``raytrace3_tpu/render/camera.py`` (reference ``Camera``,
Camera.h:4-114).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.types import Record
from ..core.vecmath import cross, normalize

#: Reference field of view (Camera.h:44): 50 degrees.
DEFAULT_FOV_DEG = 50.0
#: Reference canvas (Camera.h:16-17).
DEFAULT_RES = 1024


@dataclass
class Camera(Record):
    pos: torch.Tensor   # (3,)
    dir: torch.Tensor   # (3,) forward, scaled by 0.5 / tan(fov / 2)
    du: torch.Tensor    # (3,) unit right
    dv: torch.Tensor    # (3,) unit up-ish
    width: int = DEFAULT_RES
    height: int = DEFAULT_RES


def look_at(pos: torch.Tensor, look: torch.Tensor, width: int = DEFAULT_RES,
            height: int = DEFAULT_RES, fov_deg: float = DEFAULT_FOV_DEG) -> Camera:
    """The reference basis (Camera.h:32-54): up = (0, 0, 1),
    du = normalize(dir x up), dv = normalize(-dir x du),
    dir *= 0.5 / tan(fov / 2).  ``pos`` and ``look`` are float32 (3,)."""
    up = torch.zeros_like(pos)
    up[2] = 1.0
    d = normalize(look - pos)
    du = normalize(cross(d, up))
    dv = normalize(-cross(d, du))
    # The scale in float32, as on the JAX side, then applied as a scalar.
    fov = torch.deg2rad(torch.tensor(fov_deg, dtype=torch.float32))
    d = d * float(0.5 / torch.tan(fov / 2.0))
    return Camera(pos=pos, dir=d, du=du, dv=dv, width=width, height=height)


def emit_rays(cam: Camera):
    """Primary rays for every pixel in row-major (y * W + x) order
    (Camera.h:18-22).  Returns (org, dir), each (H * W, 3)."""
    h, w = cam.height, cam.width
    dev = cam.pos.device
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w - 0.5
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h - 0.5
    d = (cam.du[None, None, :] * x[None, :, None]
         + cam.dv[None, None, :] * y[:, None, None]
         + cam.dir[None, None, :])
    d = normalize(d).reshape(h * w, 3)
    return cam.pos.expand(h * w, 3), d
