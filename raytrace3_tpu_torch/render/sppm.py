"""SPPM engine: photon rounds, progressive radius update, image estimate.

Port of ``raytrace3_tpu/render/sppm.py`` (reference ``RayTracer::{PhotonMap,
render}`` + ``HitPoint::update``, Raytracer.h:69-79, 210-295, 366-387): the
static-lane or the regen photon walk, with every round in the deposit
backend's layout space when it offers ``packed_call`` and is not
differentiable (the tile deposit), else in hit-point order, where autograd
reaches the deposit's custom backward.  With ``deposit_compact_frac`` < 1
each round's valid deposits are compacted before the deposit op, and those
the buffer cannot hold are counted in ``deposits_dropped``.
"""

from __future__ import annotations

import math
import torch

from ..core.sampling import as_draws
from ..core.types import Deposits, HitPoints
from ..geometry.scene import Scene
from ..utils.trace import bezier_tally, span
from .deposit import deposit_bruteforce
from .eye import INIT_R2, MAX_DEPTH, eye_pass
from .light import emit_photons
from .photon import (compact_deposits, photon_trace, photon_trace_regen,
                     regen_state_init)

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


def compact_round(dep: Deposits, frac: float):
    """(deposits, dropped): a round's deposits compacted to ``max(int(D x
    frac), 128)`` records and the count of valid ones left out (lost flux);
    ``frac`` >= 1 leaves the round as it is."""
    dropped = torch.zeros((), dtype=torch.int32, device=dep.valid.device)
    if frac < 1.0:
        cap = max(int(dep.valid.shape[0] * frac), 128)
        nv = dep.valid.sum(dtype=torch.int32)
        dropped = torch.clamp_min(nv - cap, 0)
        dep = compact_deposits(dep, cap)
    return dep, dropped


class RoundState:
    """The hit-point state photon rounds update, and how a round's deposits
    reach it.

    With a backend that has ``prepare``, ``pack_state`` and ``packed_call``
    and is not differentiable (the tile deposit), every round runs in the
    backend's layout space: the state is scattered in once and gathered out
    by :meth:`finish`.  Otherwise it stays in hit-point order, where
    autograd reaches a differentiable backend's custom backward.
    """

    def __init__(self, deposit_fn, hp: HitPoints):
        self.hp = hp
        self.packed = (hasattr(deposit_fn, "packed_call") and hasattr(deposit_fn, "prepare")
                       and not getattr(deposit_fn, "differentiable", False))
        self.deposit_fn = deposit_fn
        self.prep = deposit_fn.prepare(hp) if hasattr(deposit_fn, "prepare") else None
        self.aux = getattr(deposit_fn, "returns_aux", False)
        if self.packed:
            r2_pad, self.wgt_pad = deposit_fn.pack_state(hp, self.prep)
            nphot_pad = torch.zeros_like(r2_pad)
            nphot_pad[self.prep.g] = hp.nphot
            tao_pad = torch.zeros_like(self.wgt_pad)
            tao_pad[self.prep.g] = hp.tao
            self.state = (r2_pad, tao_pad, nphot_pad)
        else:
            self.state = hp

    def deposit(self, state, dep: Deposits):
        """(photon counts, raw flux, overflow) of one batch of deposits into
        ``state``; the raw flux becomes the PPM update's by :meth:`flux`."""
        if self.packed:
            return self.deposit_fn.packed_call(state[0], dep, self.prep)
        kw = {} if self.prep is None else {"prep": self.prep}
        out = self.deposit_fn(state, dep, **kw)
        if self.aux:
            return out
        return out[0], out[1], torch.zeros((), dtype=torch.int32, device=out[0].device)

    def flux(self, raw):
        """Layout space applies the hit points' weights and 1 / pi here
        (Raytracer.h:156); hit-point order got them from the backend."""
        return self.wgt_pad * raw / math.pi if self.packed else raw

    def update(self, state, cnt, d_tao, mode: str):
        if self.packed:
            return ppm_update_arrays(*state, cnt, d_tao, mode)
        return ppm_update(state, cnt, d_tao, mode)

    def finish(self, state) -> HitPoints:
        if not self.packed:
            return state
        # Invalid hit points keep their values (their slots hold r2 = -1).
        r2_p, tao_p, nph_p = state
        hp, g, v = self.hp, self.prep.g, self.hp.valid
        return hp.replace(r2=torch.where(v, r2_p[g], hp.r2),
                          tao=torch.where(v[:, None], tao_p[g], hp.tao),
                          nphot=torch.where(v, nph_p[g], hp.nphot))


def run_rounds(scene: Scene, rng, n_rounds: int, photons_per_round: int, fold,
               max_depth: int = MAX_DEPTH, newton_fn=None, debias_roulette: bool = False,
               regen: bool = False, deposit_compact_frac: float = 1.0):
    """Trace ``n_rounds`` rounds of ``photons_per_round`` photons a light and
    hand each round's deposits, compacted (:func:`compact_round`), to
    ``fold(dep) -> overflow``.  A fresh batch each round (``regen=False``:
    the emission's uniforms, then each segment's), or persistent lanes that
    refill from the lights every segment (``regen=True``).  Returns
    (emitted per light, dropped and overflowed deposits)."""
    draws = as_draws(rng)
    L = scene.light_pos.shape[0]
    dev = scene.light_pos.device
    drops = torch.zeros((), dtype=torch.int32, device=dev)
    if not regen:
        for _ in range(n_rounds):
            with span("rt3.walk"):
                org, dir, flux = emit_photons(draws, scene.light_pos, scene.light_color,
                                              photons_per_round)
                dep = photon_trace(scene, draws, org, dir, flux, max_depth,
                                   debias_roulette=debias_roulette, newton_fn=newton_fn)
                dep, dropped = compact_round(dep, deposit_compact_frac)
            with span("rt3.fold"):
                drops = drops + dropped + fold(dep)
        return torch.tensor(float(n_rounds * photons_per_round), device=dev), drops

    pstate = regen_state_init(L, photons_per_round, dev)
    emitted = torch.zeros((L,), dtype=torch.float32, device=dev)
    for _ in range(n_rounds):
        with span("rt3.walk"):
            dep, pstate, e = photon_trace_regen(
                scene, draws, scene.light_pos, scene.light_color,
                photons_per_round, pstate, max_depth,
                debias_roulette=debias_roulette, newton_fn=newton_fn)
            dep, dropped = compact_round(dep, deposit_compact_frac)
        with span("rt3.fold"):
            drops = drops + dropped + fold(dep)
        emitted = emitted + e
    # Per-light counts agree to within one photon: their mean normalises.
    return emitted.mean(), drops


def photon_rounds(scene: Scene, rng, hp: HitPoints, n_rounds: int,
                  photons_per_round: int, max_depth: int = MAX_DEPTH,
                  update_mode: str = "sppm", deposit_fn=deposit_bruteforce,
                  newton_fn=None, debias_roulette: bool = False,
                  regen: bool = False, deposit_compact_frac: float = 1.0,
                  psum=None):
    """Photon-mapping rounds (Raytracer.h:210-295): :func:`run_rounds`'s
    batches deposited into the hit points and folded in by the PPM update,
    in the state :class:`RoundState` picks.  ``rng``: a
    ``torch.Generator`` or a draws source.  ``psum``: with photons sharded
    over ranks (``parallel/shard.py``), the sum over those ranks
    (``Mesh.all_reduce`` or ``all_reduce_grad``), applied to each round's
    photon counts and flux increments before the update, in layout space
    on the packed path (JAX's ``psum_axis``).

    Returns (hp, emitted_per_light, deposits_dropped): normalise the image
    by ``emitted_per_light`` (rounds x photons without regen); a nonzero
    drop count means the compaction or a capped deposit backend lost flux.
    """
    with span("rt3.prepare"):
        rs = RoundState(deposit_fn, hp)
    state = rs.state

    def fold(dep):
        nonlocal state
        cnt, raw, ovf = rs.deposit(state, dep)
        d_tao = rs.flux(raw)
        if psum is not None:
            cnt, d_tao = psum(cnt), psum(d_tao)
        state = rs.update(state, cnt, d_tao, update_mode)
        return ovf

    emitted, drops = run_rounds(scene, rng, n_rounds, photons_per_round, fold, max_depth,
                                newton_fn, debias_roulette, regen, deposit_compact_frac)
    return rs.finish(state), emitted, drops


def estimate_image(hp: HitPoints, n_pixels: int, total_photons) -> torch.Tensor:
    """Radiance per pixel: sum over the pixel's hit points of
    tao / (pi r2 photons) (Raytracer.h:281-294).  Returns (n_pixels, 3).

    Each pixel adds its hit points in buffer order, as JAX's scatter-add
    on the CPU does, on every device: the k-th hit point of every pixel is
    added in the k-th ``index_add_``, whose indices are then distinct, so
    the card's atomics meet no two adds to one pixel and the image is the
    same bit for bit on every run."""
    scale = torch.where(hp.valid, 1.0 / (math.pi * hp.r2 * total_photons), 0.0)
    contrib = hp.tao * scale[:, None]
    img = torch.zeros((n_pixels, 3), dtype=hp.tao.dtype, device=hp.tao.device)
    key = torch.where(hp.valid, hp.pixel.long(), n_pixels)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    pos = torch.arange(key.shape[0], device=key.device)
    start = torch.ones_like(hp.valid)
    start[1:] = sk[1:] != sk[:-1]
    place = torch.empty_like(pos)
    place[order] = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    place = torch.where(hp.valid, place, -1)
    for k in range(int(place.max()) + 1 if place.numel() else 0):
        m = place == k
        img.index_add_(0, key[m], contrib[m])
    return img


def render_pass(scene: Scene, cam_org: torch.Tensor, cam_dir: torch.Tensor,
                rng, hitpoint_capacity: int, n_rounds: int,
                photons_per_round: int, max_depth: int = MAX_DEPTH,
                slots: int = 1, init_r2: float = INIT_R2,
                update_mode: str = "sppm", deposit_fn=deposit_bruteforce,
                newton_fn=None, deposit_compact_frac: float = 1.0,
                debias_roulette: bool = False,
                photon_scene: Scene | None = None, photon_regen: bool = False,
                eye_compact_schedule: tuple = ()):
    """One SPPM pass: eye trace -> photon rounds -> pixel estimate
    (Raytracer.h:366-387).  ``photon_regen`` picks the persistent-lane
    walk, ``eye_compact_schedule`` the staged eye wavefront (empty: the
    slot wavefront with ``slots`` slots a pixel), ``deposit_compact_frac``
    the deposit compaction, as in the JAX package, except that a stage of
    the staged wavefront grows rather than drop rays (``eye_pass``'s
    default ``grow``; ``eye_grown_lanes`` counts the lanes added).  Returns (image
    (R, 3), stats); the stats hold the pass's Bezier compaction tally
    (``utils.trace.BEZIER_COUNTERS``) beside the drop counters, and
    ``eye_kernel_segments``, the eye segments that ran through the eye's
    CUDA kernels.  Under a
    profiler the stages are the spans ``rt3.eye``, ``rt3.prepare``,
    ``rt3.walk`` and ``rt3.fold`` (each round) and ``rt3.estimate``."""
    with bezier_tally() as tally:
        with span("rt3.eye"):
            hp, stats = eye_pass(scene, cam_org, cam_dir, hitpoint_capacity,
                                 max_depth, slots, init_r2, newton_fn=newton_fn,
                                 compact_schedule=eye_compact_schedule)
        hp, emitted, dep_drops = photon_rounds(
            photon_scene if photon_scene is not None else scene, rng, hp,
            n_rounds, photons_per_round, max_depth, update_mode, deposit_fn,
            newton_fn, debias_roulette=debias_roulette, regen=photon_regen,
            deposit_compact_frac=deposit_compact_frac)
        with span("rt3.estimate"):
            img = estimate_image(hp, cam_org.shape[0], emitted)
    stats = dict(stats)
    stats["photons_emitted"] = emitted
    stats["deposits_dropped"] = dep_drops
    stats["mean_r2"] = torch.where(hp.valid, hp.r2, 0.0).sum() / torch.clamp_min(
        hp.valid.sum(dtype=torch.int32), 1)
    stats.update(tally.fold(img.device))
    return img, stats


def tonemap(x: torch.Tensor) -> torch.Tensor:
    """toInt(x) = floor((1 - e^-x)^(1/2.2) * 255 + 0.5) as uint8
    (Raytracer.h:24-26)."""
    v = torch.pow(1.0 - torch.exp(-torch.clamp_min(x, 0.0)), 1.0 / 2.2)
    return torch.clamp(torch.floor(v * 255.0 + 0.5), 0, 255).to(torch.uint8)
