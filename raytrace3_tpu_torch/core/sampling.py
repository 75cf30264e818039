"""Samplers that take uniforms, and the sources those uniforms come from.

Port of ``raytrace3_tpu/core/sampling.py``.  The JAX samplers draw from a
key; here each sampler takes its uniforms as tensors, and the functions that
walk rays draw them from a *draws source*: any object with
``uniform(shape, lo, hi)``.  A ``torch.Generator`` on the pass's device is
the usual source (:class:`GeneratorDraws`); :class:`ReplayDraws` hands out
recorded arrays in order, which is how the tests feed the port the very
numbers ``jax.random`` drew for the reference.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from .vecmath import orthonormal_frame

TWO_PI = 2.0 * math.pi


def uniform_sphere(z: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Uniform directions on the unit sphere from z ~ U(-1, 1) and
    phi ~ U(0, 2 pi) (Vec3.h:57-65 law), shape ``(*z.shape, 3)``."""
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def cosine_hemisphere(u1: torch.Tensor, u2: torch.Tensor,
                      n: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions about unit normals ``n`` from two U(0, 1)
    draws: theta = acos(sqrt(u1)), phi = 2 pi u2 (Vec3.h:90-98 law)."""
    ct = torch.sqrt(u1)
    st = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    phi = TWO_PI * u2
    t, b = orthonormal_frame(n)
    return (t * (st * torch.cos(phi))[..., None]
            + b * (st * torch.sin(phi))[..., None]
            + n * ct[..., None])


def roulette(u: torch.Tensor, diff_p: torch.Tensor, refl_p: torch.Tensor,
             refr_p: torch.Tensor) -> torch.Tensor:
    """Branch id per lane from u ~ U(0, 1): 0=DIFF, 1=REFL, 2=REFR
    (Obj.h:30-45; all-zero powers resolve to REFR)."""
    r = u * (diff_p + refl_p + refr_p)
    return torch.where(diff_p > r, 0, torch.where(diff_p + refl_p > r, 1, 2))


class GeneratorDraws:
    """Uniforms from a ``torch.Generator``, made on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator,
                       device=self.generator.device)
        return u * (hi - lo) + lo


class ReplayDraws:
    """Recorded uniforms, handed out in order; each must have the shape
    asked for.  The arrays already lie in [lo, hi)."""

    def __init__(self, arrays, device="cpu"):
        self._queue = deque(arrays)
        self.device = torch.device(device)

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        if not self._queue:
            raise RuntimeError(f"no recorded draw left for shape {shape}")
        a = torch.as_tensor(np.array(self._queue.popleft()), device=self.device)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"recorded draw has shape {tuple(a.shape)}, "
                             f"the caller asked for {tuple(shape)}")
        return a

    @property
    def remaining(self) -> int:
        return len(self._queue)


class RecordingDraws:
    """Draws from another source, kept (on the CPU) so that a second run
    can replay them with :class:`ReplayDraws`."""

    def __init__(self, source):
        self.source = source
        self.arrays = []

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = self.source.uniform(shape, lo, hi)
        self.arrays.append(u.cpu().numpy().copy())
        return u


def as_draws(rng):
    """A draws source from a ``torch.Generator`` or a draws source."""
    return GeneratorDraws(rng) if isinstance(rng, torch.Generator) else rng
