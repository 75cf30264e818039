"""Sharded SPPM rendering: passes over the pass axis, eye rays and photons
over the photon axis.

Port of ``raytrace3_tpu/parallel/shard.py`` (reference: the 4-thread OpenMP
pass loop and its serial canvas merge, Raytracer.h:425-458).  Every rank of
a ``Mesh`` runs the same program on its own share:

  * pass axis: each pass group renders one jittered pass; the canvases are
    summed over the axis and divided by its size;
  * photon axis: the rank traces its slice of the camera rays (its hit
    points carry global pixel ids), then either all hit points are
    all-gathered and each round's deposits summed over the axis before the
    radius update (the hit points stay replicated), or, with
    ``hp_sharded``, each rank keeps its shard and the deposits travel the
    ring (``parallel/ring.py``).

The draws follow JAX's folds of the pass key: a pass group's camera jitter
comes from one source shared by its ranks (JAX's ``kj``), each rank's
photons from its own (``fold_in(kp, photon index)``).
:func:`shard_generators` makes both from (seed, super-pass, pass index,
photon index); a test hands in JAX's recorded draws instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.sampling import TWO_PI, as_draws, uniform_sphere
from ..core.types import HitPoints
from ..geometry.scene import Scene
from ..render.camera import emit_rays, look_at
from ..render.deposit import deposit_bruteforce
from ..render.eye import eye_pass
from ..render.sppm import estimate_image, photon_rounds
from ..utils.config import RenderConfig
from .mesh import AXES, PASS_AXIS, PHOTON_AXIS, Mesh, make_mesh
from .ring import photon_rounds_ring


def shard_generators(seed: int, i: int, mesh: Mesh):
    """(camera jitter generator, photon generator) of super-pass ``i`` on
    this rank: the first is the same on every rank of a pass group, the
    second this rank's own, each a pure function of its indices (JAX's
    ``kj`` and ``fold_in(kp, photon index)`` of ``fold_in(key, pass
    index)``)."""
    def gen(*words):
        state = np.random.SeedSequence([seed, i, mesh.pass_index, *words]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=mesh.device).manual_seed(int(state))

    return gen(0), gen(1, mesh.photon_index)


def gather_hitpoints(mesh: Mesh, hp: HitPoints, axis: str = PHOTON_AXIS,
                     grad: bool = False) -> HitPoints:
    """Every rank's hit points along ``axis``, concatenated in axis order;
    with ``grad`` the float fields through ``Mesh.all_gather_grad``."""
    def one(x):
        if grad and x.is_floating_point():
            return mesh.all_gather_grad(x, axis)
        if x.dtype == torch.bool:
            return mesh.all_gather(x.to(torch.uint8), axis).bool()
        return mesh.all_gather(x, axis)

    return HitPoints(**{f.name: one(getattr(hp, f.name)) for f in dataclasses.fields(hp)})


def make_sharded_pass_fn(scene: Scene, cfg: RenderConfig, base_pos, base_look,
                         mesh: Mesh, deposit_fn=None, newton_fn=None,
                         hp_sharded: bool = False):
    """``run(jitter, photons) -> (image (H, W, 3), stats)``: this rank's
    share of one jittered pass a pass group, the image the mean over the
    pass axis (the same on every rank).

    ``jitter`` and ``photons``: draws sources (``torch.Generator`` s on the
    rank's device, :func:`shard_generators`); the camera jitter is drawn
    from ``jitter``, then the photon walks from ``photons``; one generator
    passed as both draws as ``render.driver.make_pass_fn`` does, and on a
    1 x 1 mesh the pass is then that function's pass.  The config's eye
    schedule, regen walk, deposit compaction and layout-space rounds run as
    on one card.  ``stats``: both drop counters (``dropped``, the eye's;
    ``deposits_dropped``) and ``photons_emitted``, summed over the mesh.
    """
    dev = scene.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    base_pos, base_look = f32(base_pos), f32(base_look)
    if deposit_fn is None:
        deposit_fn = deposit_bruteforce
    n_photon, n_pass = mesh.size(PHOTON_AXIS), mesh.size(PASS_AXIS)
    R = cfg.n_pixels
    if R % n_photon:
        raise ValueError(f"pixels {R} not divisible by photon axis {n_photon}")
    if cfg.photons_per_round % n_photon:
        raise ValueError("photons_per_round not divisible by photon axis")
    ray_shard = R // n_photon
    local_capacity = cfg.hitpoint_capacity // n_photon
    local_photons = cfg.photons_per_round // n_photon
    photon_scene = scene
    if cfg.bezier_compact_frac_photon >= 0.0 and scene.has_bezier:
        photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
    walk = dict(max_depth=cfg.max_depth, update_mode=cfg.update_mode, deposit_fn=deposit_fn,
                newton_fn=newton_fn, deposit_compact_frac=cfg.deposit_compact_frac,
                debias_roulette=cfg.debias_roulette, regen=cfg.photon_regen)

    def run(jitter, photons):
        draws = as_draws(jitter)
        z = draws.uniform((), -1.0, 1.0)
        phi = draws.uniform((), 0.0, TWO_PI)
        pos = base_pos + cfg.jitter * uniform_sphere(z, phi)
        org, dir = emit_rays(look_at(pos, base_look, cfg.width, cfg.height))
        lo = mesh.photon_index * ray_shard
        hp_local, eye_stats = eye_pass(
            scene, org[lo:lo + ray_shard], dir[lo:lo + ray_shard], local_capacity,
            cfg.max_depth, cfg.slots, cfg.init_r2, newton_fn=newton_fn, pixel_offset=lo,
            compact_schedule=cfg.eye_compact_schedule)
        if hp_sharded:
            hp, emitted, dep_drops = photon_rounds_ring(
                photon_scene, photons, hp_local, cfg.rounds, local_photons, mesh, **walk)
            total = mesh.all_reduce(emitted, PHOTON_AXIS)
            img = mesh.all_reduce(estimate_image(hp, R, total), PHOTON_AXIS)
        else:
            hp = gather_hitpoints(mesh, hp_local)
            hp, emitted, dep_drops = photon_rounds(
                photon_scene, photons, hp, cfg.rounds, local_photons,
                psum=lambda x: mesh.all_reduce(x, PHOTON_AXIS), **walk)
            total = mesh.all_reduce(emitted, PHOTON_AXIS)
            img = estimate_image(hp, R, total)
        img = mesh.all_reduce(img, PASS_AXIS) / n_pass
        stats = {"dropped": mesh.all_reduce(eye_stats["dropped"], AXES),
                 "deposits_dropped": mesh.all_reduce(dep_drops, AXES),
                 "photons_emitted": mesh.all_reduce(total, PASS_AXIS)}
        return img.reshape(cfg.height, cfg.width, 3), stats

    return run


def render_sharded(cfg: RenderConfig, mesh: Mesh | None = None, scene: Scene | None = None,
                   deposit_fn=None, newton_fn=None, camera_pose=None,
                   hp_sharded: bool = False, metrics_jsonl: str | None = None,
                   pass_rngs=None):
    """The sharded progressive render: ``ceil(passes / n_pass)`` super-passes,
    each ``n_pass`` jittered passes at once, their mean returned as (image
    (H, W, 3) numpy, {"meter": summary, "dropped", "deposits_dropped",
    "photons_emitted"}) on every rank.

    Both drop counters and the emitted photons are summed over the mesh and
    over every super-pass (JAX's ``render_sharded`` reports the last one's
    counters only).  ``metrics_jsonl``: one ``PassMeter`` record a
    super-pass (pass it on one rank only).  ``pass_rngs(i)``: super-pass
    i's (jitter, photons) draws; default :func:`shard_generators`.
    """
    from ..render.driver import CAMERA_LOOK, CAMERA_POS, build_scene
    from ..utils.metrics import PassMeter

    if mesh is None:
        mesh = make_mesh()
    if scene is None:
        scene = build_scene(cfg, mesh.device)
    base_pos, base_look = camera_pose if camera_pose is not None else (CAMERA_POS, CAMERA_LOOK)
    if pass_rngs is None:
        pass_rngs = lambda i: shard_generators(cfg.seed, i, mesh)
    n_pass = mesh.size(PASS_AXIS)
    fn = make_sharded_pass_fn(scene, cfg, base_pos, base_look, mesh, deposit_fn, newton_fn,
                              hp_sharded=hp_sharded)
    n_super = max(1, -(-cfg.passes // n_pass))
    L = scene.light_pos.shape[0]
    photons_per_super = n_pass * cfg.rounds * cfg.photons_per_round * L
    rays_per_super = n_pass * (cfg.max_depth + 1) * (
        cfg.n_pixels * cfg.slots + cfg.rounds * cfg.photons_per_round * L)
    meter = PassMeter(photons_per_super, rays_per_super, metrics_jsonl)

    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    totals = {}
    for i in range(n_super):
        meter.start_pass()
        img, stats = fn(*pass_rngs(i))
        accum = accum + img
        if accum.is_cuda:
            torch.cuda.synchronize(accum.device)
        stats = {k: float(v) for k, v in stats.items()}
        meter.end_pass({"dropped": int(stats["dropped"]),
                        "deposits_dropped": int(stats["deposits_dropped"])},
                       photons=stats["photons_emitted"] * L)
        for k, v in stats.items():
            totals[k] = totals.get(k, 0.0) + v
    return accum.cpu().numpy() / n_super, {
        "meter": meter.summary(), "dropped": int(totals["dropped"]),
        "deposits_dropped": int(totals["deposits_dropped"]),
        "photons_emitted": totals["photons_emitted"]}
