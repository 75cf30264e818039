"""Photon sources: batched isotropic point-light emission.

Port of ``raytrace3_tpu/render/light.py`` (reference ``Light::emit``,
Light.h:8-13): origin = the light's position, direction uniform on the
sphere, flux = colour x 4 pi; ``n_photons`` per light, stacked light by
light (Raytracer.h:226-233).
"""

from __future__ import annotations

import math

import torch

from ..core.sampling import TWO_PI, as_draws, uniform_sphere


def emit_photons(rng, light_pos: torch.Tensor, light_color: torch.Tensor,
                 n_photons: int):
    """``n_photons`` photons per light: org, dir, flux, each (L * n, 3).

    ``rng``: a ``torch.Generator`` or a draws source; it is asked for z
    ~ U(-1, 1) and then phi ~ U(0, 2 pi), each of shape (L, n_photons), as
    JAX's ``uniform_sphere`` splits its key.
    """
    draws = as_draws(rng)
    L = light_pos.shape[0]
    z = draws.uniform((L, n_photons), -1.0, 1.0)
    phi = draws.uniform((L, n_photons), 0.0, TWO_PI)
    dirs = uniform_sphere(z, phi)                             # (L, n, 3)
    org = light_pos[:, None, :].expand(dirs.shape)
    flux = (light_color * (4.0 * math.pi))[:, None, :].expand(dirs.shape)
    n = L * n_photons
    return org.reshape(n, 3), dirs.reshape(n, 3), flux.reshape(n, 3)
