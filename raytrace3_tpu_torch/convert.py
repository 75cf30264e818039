"""Records to and from flat numpy dicts.

The JAX package's records (flax dataclasses) and the port's (dataclasses of
tensors) share field names, so one flattening serves both:
``flatten_to_numpy`` walks dataclass fields and names each array by its
dotted path (``"planes.p0"``, ``"materials.diff"``, ...); static fields
(Python scalars) are left out.  The ``*_from_numpy`` builders make port
records from such dicts, so both sides can compute on identical data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import Deposits, HitPoints, Materials
from .geometry.bezier import BezierObject
from .geometry.plane import Planes
from .geometry.scene import Scene
from .geometry.sphere import Spheres


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def flatten_to_numpy(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """Every array field of a (nested) dataclass, keyed by dotted path."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (bool, int, float, str)):
            continue
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(flatten_to_numpy(v, key + "."))
        else:
            out[key] = _to_numpy(v)
    return out


def _record(cls, d: dict, prefix: str, device):
    return cls(**{f.name: torch.as_tensor(np.array(d[prefix + f.name]), device=device)
                  for f in dataclasses.fields(cls)})


def scene_from_numpy(d: dict, *, device="cpu", bezier_uv_quirk: bool = True,
                     bezier_compact_frac: float = 1.0,
                     newton_iters: int = 10, newton_restarts: int = 4) -> Scene:
    """A port ``Scene`` from a flattened scene; the static fields are given."""
    t = lambda k: torch.as_tensor(np.array(d[k]), device=device)
    return Scene(
        planes=_record(Planes, d, "planes.", device),
        spheres=_record(Spheres, d, "spheres.", device),
        bezier=(BezierObject(ctrl=t("bezier.ctrl")) if "bezier.ctrl" in d
                else None),
        materials=_record(Materials, d, "materials.", device),
        obj_color=t("obj_color"), obj_tex=t("obj_tex"), atlas=t("atlas"),
        light_pos=t("light_pos"), light_color=t("light_color"),
        bezier_uv_quirk=bezier_uv_quirk,
        bezier_compact_frac=bezier_compact_frac,
        newton_iters=newton_iters, newton_restarts=newton_restarts,
    )


def hitpoints_from_numpy(d: dict, device="cpu") -> HitPoints:
    return _record(HitPoints, d, "", device)


def deposits_from_numpy(d: dict, device="cpu") -> Deposits:
    return _record(Deposits, d, "", device)


def params_from_numpy(d: dict, device="cpu") -> dict:
    """The port's parameter dict (``diff.train.extract_params``) from the
    JAX package's, as numpy arrays: ``diff``, ``atlas`` and ``ctrl``."""
    return {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}
