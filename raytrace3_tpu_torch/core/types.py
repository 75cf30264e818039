"""Batched records as dataclasses of tensors.

Port of ``raytrace3_tpu/core/types.py``: each flax pytree becomes a plain
dataclass with the same field names, shapes and dtypes, so
``convert.flatten_to_numpy`` reads both sides alike.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .vecmath import any_near_zero, mean_power


class Record:
    """``replace`` as on the JAX side (``flax.struct.dataclass.replace``)."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class Materials(Record):
    """Per-object material table (Element.h:7-19)."""

    diff: torch.Tensor   # (N, 3)
    refl: torch.Tensor   # (N, 3)
    refr: torch.Tensor   # (N, 3)
    refrn: torch.Tensor  # (N,)
    refln: torch.Tensor  # (N,)

    # A lobe is active only when NO channel is within 1e-4 of zero.
    def is_diff(self) -> torch.Tensor:
        return ~any_near_zero(self.diff)

    def is_refl(self) -> torch.Tensor:
        return ~any_near_zero(self.refl)

    def is_refr(self) -> torch.Tensor:
        return ~any_near_zero(self.refr)

    def powers(self):
        return mean_power(self.diff), mean_power(self.refl), mean_power(self.refr)


def eta_from_refrn(rn: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """n_from / n_to at a refraction (Raytracer.h:187,332), guarded against
    the refrn == 0 of materials whose refraction lobe is off."""
    safe = torch.where(torch.abs(rn) < 1e-6, 1.0, rn)
    return torch.where(inside, safe, 1.0 / safe)


@dataclass
class HitRecord(Record):
    """Nearest-hit data for a batch of rays (Element.h:20-38)."""

    t: torch.Tensor        # (R,) distance, MAX_DIST on a miss
    hit: torch.Tensor      # (R,) bool
    pos: torch.Tensor      # (R, 3)
    n: torch.Tensor        # (R, 3) normal as the reference stores it
    inside: torch.Tensor   # (R,) bool, sphere entry/exit flag
    obj_id: torch.Tensor   # (R,) int32, -1 on a miss
    color: torch.Tensor    # (R, 3) surface colour at the hit


@dataclass
class HitPoints(Record):
    """SPPM camera-side measurement points, fixed capacity C
    (Raytracer.h:47-80)."""

    pos: torch.Tensor    # (C, 3)
    n: torch.Tensor      # (C, 3)
    wgt: torch.Tensor    # (C, 3) pixel weight
    pixel: torch.Tensor  # (C,) int32 flattened pixel id y*W + x
    valid: torch.Tensor  # (C,) bool
    r2: torch.Tensor     # (C,) gather radius^2
    nphot: torch.Tensor  # (C,) accumulated photon count N
    tao: torch.Tensor    # (C, 3) accumulated reflected flux

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def make_hitpoints(capacity: int, init_r2: float, device,
                   dtype=torch.float32) -> HitPoints:
    z3 = lambda: torch.zeros((capacity, 3), dtype=dtype, device=device)
    return HitPoints(
        pos=z3(), n=z3(), wgt=z3(),
        pixel=torch.zeros((capacity,), dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        r2=torch.full((capacity,), init_r2, dtype=dtype, device=device),
        nphot=torch.zeros((capacity,), dtype=dtype, device=device),
        tao=z3(),
    )


@dataclass
class Deposits(Record):
    """Photon deposit events of one round, fixed capacity D; ``flux`` is
    the flux on arrival, before the albedo multiply (Raytracer.h:156)."""

    pos: torch.Tensor    # (D, 3)
    n: torch.Tensor      # (D, 3)
    flux: torch.Tensor   # (D, 3)
    valid: torch.Tensor  # (D,) bool
