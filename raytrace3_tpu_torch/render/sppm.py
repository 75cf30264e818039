"""SPPM engine: photon rounds, progressive radius update, image estimate.

Port of ``raytrace3_tpu/render/sppm.py`` (reference ``RayTracer::{PhotonMap,
render}`` + ``HitPoint::update``, Raytracer.h:69-79, 210-295, 366-387): the
static-lane or the regen photon walk, with every round in the deposit
backend's layout space when it offers ``packed_call`` and is not
differentiable (the tile deposit), else in hit-point order, where autograd
reaches the deposit's custom backward.  Deposit compaction waits for a
later slice.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from ..core.sampling import as_draws
from ..core.types import HitPoints
from ..geometry.scene import Scene
from .deposit import deposit_bruteforce
from .eye import INIT_R2, MAX_DEPTH, eye_pass
from .light import emit_photons
from .photon import photon_trace, photon_trace_regen, regen_state_init

#: Reference radius-shrink factor (Raytracer.h:45).
ALPHA = 0.7


def ppm_update_arrays(r2, tao, nphot, d_nphot, d_tao,
                      mode: str = "sppm", alpha: float = ALPHA):
    """The PPM shrink on bare arrays (hit-point order or layout space).

    ``"sppm"``: k = (N + a dN) / (N + dN); r2 *= k; tao = (tao + dtao) k;
    N += a dN.  ``"reference"``: the reference as executed, whose guard
    makes the update unreachable (Raytracer.h:74): radii never shrink.
    """
    if mode == "reference":
        return r2, tao + d_tao, nphot + d_nphot
    if mode != "sppm":
        raise ValueError(f"unknown ppm update mode: {mode}")
    has_new = d_nphot > 0.0
    denom = torch.where(has_new, nphot + d_nphot, 1.0)
    k = torch.where(has_new, (nphot + alpha * d_nphot) / denom, 1.0)
    return r2 * k, (tao + d_tao) * k[:, None], nphot + alpha * d_nphot


def ppm_update(hp: HitPoints, d_nphot, d_tao, mode: str = "sppm",
               alpha: float = ALPHA) -> HitPoints:
    r2, tao, nphot = ppm_update_arrays(hp.r2, hp.tao, hp.nphot, d_nphot,
                                       d_tao, mode, alpha)
    return hp.replace(r2=r2, tao=tao, nphot=nphot)


def photon_rounds(scene: Scene, rng, hp: HitPoints, n_rounds: int,
                  photons_per_round: int, max_depth: int = MAX_DEPTH,
                  update_mode: str = "sppm", deposit_fn=deposit_bruteforce,
                  newton_fn=None, debias_roulette: bool = False,
                  regen: bool = False):
    """Photon-mapping rounds (Raytracer.h:210-295).

    ``photons_per_round`` photons per light walk ``max_depth + 1`` segments
    per round: a fresh batch each round (``regen=False``, drawing the
    emission and then each segment's uniforms), or persistent lanes that
    refill from the lights every segment (``regen=True``).  ``rng``: a
    ``torch.Generator`` or a draws source.

    Returns (hp, emitted_per_light, deposits_dropped): normalise the image
    by ``emitted_per_light`` (rounds x photons without regen); a nonzero
    drop count means a capped deposit backend lost flux.
    """
    draws = as_draws(rng)
    # A differentiable backend keeps the hit-point-order path: packed_call
    # would bypass its custom backward.
    packed_mode = (hasattr(deposit_fn, "packed_call") and hasattr(deposit_fn, "prepare")
                   and not getattr(deposit_fn, "differentiable", False))
    raw_call = deposit_fn
    if hasattr(deposit_fn, "prepare"):
        prep = deposit_fn.prepare(hp)
        raw_call = partial(deposit_fn, prep=prep)
    if getattr(deposit_fn, "returns_aux", False):
        dep_call = raw_call
    else:
        def dep_call(hp_, dep_):
            d_n, d_tao = raw_call(hp_, dep_)
            return d_n, d_tao, torch.zeros((), dtype=torch.int32, device=d_n.device)

    if packed_mode:
        # The whole rounds loop in layout space: state scatters in once and
        # gathers out once (Raytracer.h:156 applies wgt / pi per round).
        r2_pad, wgt_pad = deposit_fn.pack_state(hp, prep)
        g = prep.g
        nphot_pad = torch.zeros_like(r2_pad)
        nphot_pad[g] = hp.nphot
        tao_pad = torch.zeros_like(wgt_pad)
        tao_pad[g] = hp.tao
        state = (r2_pad, tao_pad, nphot_pad)

        def fold_state(state, dep):
            r2_p, tao_p, nph_p = state
            cnt, fl, ovf = deposit_fn.packed_call(r2_p, dep, prep)
            d_tao = wgt_pad * fl / math.pi
            return ppm_update_arrays(r2_p, tao_p, nph_p, cnt, d_tao,
                                     update_mode), ovf

        def finish_state(state):
            r2_p, tao_p, nph_p = state
            # Invalid hit points keep their values (their slots hold r2 = -1).
            v = hp.valid
            return hp.replace(r2=torch.where(v, r2_p[g], hp.r2),
                              tao=torch.where(v[:, None], tao_p[g], hp.tao),
                              nphot=torch.where(v, nph_p[g], hp.nphot))
    else:
        state = hp

        def fold_state(state, dep):
            d_n, d_tao, ovf = dep_call(state, dep)
            return ppm_update(state, d_n, d_tao, update_mode), ovf

        def finish_state(state):
            return state

    L = scene.light_pos.shape[0]
    dev = scene.light_pos.device
    drops = torch.zeros((), dtype=torch.int32, device=dev)
    if not regen:
        for _ in range(n_rounds):
            org, dir, flux = emit_photons(draws, scene.light_pos, scene.light_color,
                                          photons_per_round)
            dep = photon_trace(scene, draws, org, dir, flux, max_depth,
                               debias_roulette=debias_roulette, newton_fn=newton_fn)
            state, ovf = fold_state(state, dep)
            drops = drops + ovf
        emitted = torch.tensor(float(n_rounds * photons_per_round), device=dev)
        return finish_state(state), emitted, drops

    pstate = regen_state_init(L, photons_per_round, dev)
    emitted = torch.zeros((L,), dtype=torch.float32, device=dev)
    for _ in range(n_rounds):
        dep, pstate, e = photon_trace_regen(
            scene, draws, scene.light_pos, scene.light_color,
            photons_per_round, pstate, max_depth,
            debias_roulette=debias_roulette, newton_fn=newton_fn)
        state, ovf = fold_state(state, dep)
        emitted = emitted + e
        drops = drops + ovf
    # Per-light counts agree to within one photon: their mean normalises.
    return finish_state(state), emitted.mean(), drops


def estimate_image(hp: HitPoints, n_pixels: int, total_photons) -> torch.Tensor:
    """Radiance per pixel: sum over the pixel's hit points of
    tao / (pi r2 photons) (Raytracer.h:281-294).  Returns (n_pixels, 3)."""
    scale = torch.where(hp.valid, 1.0 / (math.pi * hp.r2 * total_photons), 0.0)
    contrib = hp.tao * scale[:, None]
    img = torch.zeros((n_pixels + 1, 3), dtype=hp.tao.dtype, device=hp.tao.device)
    idx = torch.where(hp.valid, hp.pixel, n_pixels).long()
    img.index_add_(0, idx, contrib)
    return img[:n_pixels]


def render_pass(scene: Scene, cam_org: torch.Tensor, cam_dir: torch.Tensor,
                rng, hitpoint_capacity: int, n_rounds: int,
                photons_per_round: int, max_depth: int = MAX_DEPTH,
                slots: int = 1, init_r2: float = INIT_R2,
                update_mode: str = "sppm", deposit_fn=deposit_bruteforce,
                newton_fn=None, debias_roulette: bool = False,
                photon_scene: Scene | None = None, photon_regen: bool = False,
                eye_compact_schedule: tuple = ()):
    """One SPPM pass: eye trace -> photon rounds -> pixel estimate
    (Raytracer.h:366-387).  ``photon_regen`` picks the persistent-lane
    walk, ``eye_compact_schedule`` the staged eye wavefront (empty: the
    slot wavefront), as in the JAX package.  Returns (image (R, 3),
    stats)."""
    hp, stats = eye_pass(scene, cam_org, cam_dir, hitpoint_capacity,
                         max_depth, slots, init_r2, newton_fn=newton_fn,
                         compact_schedule=eye_compact_schedule)
    hp, emitted, dep_drops = photon_rounds(
        photon_scene if photon_scene is not None else scene, rng, hp,
        n_rounds, photons_per_round, max_depth, update_mode, deposit_fn,
        newton_fn, debias_roulette=debias_roulette, regen=photon_regen)
    img = estimate_image(hp, cam_org.shape[0], emitted)
    stats = dict(stats)
    stats["photons_emitted"] = emitted
    stats["deposits_dropped"] = dep_drops
    stats["mean_r2"] = torch.where(hp.valid, hp.r2, 0.0).sum() / torch.clamp_min(
        hp.valid.sum(dtype=torch.int32), 1)
    return img, stats


def tonemap(x: torch.Tensor) -> torch.Tensor:
    """toInt(x) = floor((1 - e^-x)^(1/2.2) * 255 + 0.5) as uint8
    (Raytracer.h:24-26)."""
    v = torch.pow(1.0 - torch.exp(-torch.clamp_min(x, 0.0)), 1.0 / 2.2)
    return torch.clamp(torch.floor(v * 255.0 + 0.5), 0, 255).to(torch.uint8)
