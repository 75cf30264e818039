"""Single-pass driver: the scene from a config and the pass function.

Port of ``build_scene`` and ``make_pass_fn`` from
``raytrace3_tpu/render/driver.py``.  A pass is a plain function of its
random source; there is no jit.  The multi-pass ``render`` loop with
checkpoint and preview waits for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.sampling import TWO_PI, as_draws, uniform_sphere
from ..geometry.scene import Scene
from ..scenes import get_scene
from ..utils.config import RenderConfig
from .camera import emit_rays, look_at
from .deposit import deposit_bruteforce
from .sppm import render_pass


def build_scene(cfg: RenderConfig, device=DEFAULT_DEVICE) -> Scene:
    """The config's scene on ``device``, the card unless the caller asks
    for the CPU (``core.device``).  ``cfg.newton_restarts`` is the JAX jnp
    solver's grid side and is not read: the port's solver carries its own
    restart count."""
    scene = get_scene(cfg.scene, atlas_res=cfg.atlas_res,
                      device=resolve_device(device))
    return scene.replace(bezier_compact_frac=cfg.bezier_compact_frac,
                         newton_iters=cfg.newton_iters)


def make_pass_fn(scene: Scene, cfg: RenderConfig, base_pos, base_look,
                 deposit_fn=None, newton_fn=None):
    """The single-pass function ``rng -> (image (H, W, 3), stats)``.

    ``rng`` is a ``torch.Generator`` on the scene's device (or a draws
    source).  The camera jitter (Raytracer.h:429-441: pos + 0.00015 x a
    random unit vector, then lookAt) is drawn first, then the photon walk's
    uniforms.  Ported: either photon walk, the staged or the slot eye
    wavefront at ``slots=1``; the K-slot wavefront and deposit compaction
    wait for a later slice.
    """
    if cfg.slots != 1 or cfg.deposit_compact_frac < 1.0:
        raise NotImplementedError(
            "the port runs slots=1 and deposit_compact_frac=1.0; the K-slot "
            "eye wavefront and deposit compaction wait for a later slice")
    dev = scene.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    base_pos, base_look = f32(base_pos), f32(base_look)
    if deposit_fn is None:
        deposit_fn = deposit_bruteforce
    photon_scene = None
    if cfg.bezier_compact_frac_photon >= 0.0 and scene.has_bezier:
        photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)

    def one_pass(rng):
        draws = as_draws(rng)
        z = draws.uniform((), -1.0, 1.0)
        phi = draws.uniform((), 0.0, TWO_PI)
        pos = base_pos + cfg.jitter * uniform_sphere(z, phi)
        org, dir = emit_rays(look_at(pos, base_look, cfg.width, cfg.height))
        img, stats = render_pass(
            scene, org, dir, draws,
            hitpoint_capacity=cfg.hitpoint_capacity,
            n_rounds=cfg.rounds,
            photons_per_round=cfg.photons_per_round,
            max_depth=cfg.max_depth,
            init_r2=cfg.init_r2,
            update_mode=cfg.update_mode,
            deposit_fn=deposit_fn,
            newton_fn=newton_fn,
            debias_roulette=cfg.debias_roulette,
            photon_scene=photon_scene,
            photon_regen=cfg.photon_regen,
            eye_compact_schedule=cfg.eye_compact_schedule,
        )
        return img.reshape(cfg.height, cfg.width, 3), stats

    return one_pass
