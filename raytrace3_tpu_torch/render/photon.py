"""PASS 2 - photon trace: the photon walks emitting deposits.

Port of ``raytrace3_tpu/render/photon.py`` (reference
``RayTracer::PhotonTrace``, Raytracer.h:117-209).  Each segment intersects,
records a deposit at diffuse surfaces with the arrival flux, and
Russian-roulettes one continuation without dividing by the branch
probability (Obj.h:30-45).  Two walks:

* ``photon_trace``, the static-lane walk: one emitted batch walks
  ``max_depth + 1`` segments (:func:`static_segment` each);
* ``photon_trace_regen``, the persistent-lane walk: every segment first
  refills dead lanes with fresh photons from the lights, round-robin
  (:func:`regen_segment` each).

:func:`compact_deposits` gathers a round's valid deposits into a smaller
buffer before the deposit op.

Draw order per segment, which a replayed source must follow: (regen only:
emission z and phi, N each), the roulette uniform (N), the two
cosine-hemisphere uniforms (N each).
"""

from __future__ import annotations

import math

import torch

from ..core.sampling import (TWO_PI, as_draws, cosine_hemisphere, roulette,
                             uniform_sphere)
from ..core.types import Deposits, eta_from_refrn
from ..core.vecmath import normalize, reflect, refract
from ..geometry.scene import Scene, intersect_scene
from ..ops.compact import compact_indices
from ..ops.onehot import onehot_f32, take_rows
from .eye import MAX_DEPTH


def _material_lanes(scene: Scene):
    """Per-lane fetch of [diff_p, refl_p, refr_p, is_diff, refrn]."""
    diff_p, refl_p, refr_p = scene.materials.powers()
    tbl = torch.stack([diff_p, refl_p, refr_p,
                       scene.materials.is_diff().to(torch.float32),
                       scene.materials.refrn], 1)

    def fetch(obj):
        m = take_rows(tbl, obj)                           # (R, 5)
        return m[:, 0], m[:, 1], m[:, 2], m[:, 3] > 0.5, m[:, 4]

    return fetch


def photon_trace(scene: Scene, rng, org: torch.Tensor, dir: torch.Tensor,
                 flux: torch.Tensor, max_depth: int = MAX_DEPTH,
                 debias_roulette: bool = False, newton_fn=None) -> Deposits:
    """Walk a photon batch (N, 3) from ``light.emit_photons`` for
    ``max_depth + 1`` segments; return every diffuse-interaction deposit,
    capacity (max_depth + 1) * N, segment-major.  ``rng``: a
    ``torch.Generator`` or a draws source."""
    draws = as_draws(rng)
    fetch_mat = _material_lanes(scene)
    carry = (org, dir, flux, torch.ones((org.shape[0],), dtype=torch.bool,
                                        device=org.device))
    records = []
    for _ in range(max_depth + 1):
        carry, rec = static_segment(scene, fetch_mat, draws, carry,
                                    debias_roulette, newton_fn)
        records.append(rec)
    pos, n, f, valid = (torch.cat(x, 0) for x in zip(*records))
    return Deposits(pos=pos, n=n, flux=f, valid=valid)


def _continue(draws, rec, d, f, dp, rp, rr, rn, debias_roulette: bool):
    """Roulette one continuation (Raytracer.h:162-207): (new dir, new
    flux); draws the roulette uniform, then the two hemisphere uniforms."""
    N = d.shape[0]
    branch = roulette(draws.uniform((N,)), dp, rp, rr)
    u1 = draws.uniform((N,))
    u2 = draws.uniform((N,))
    d_diff = cosine_hemisphere(u1, u2, rec.n)
    d_refl = normalize(reflect(d, rec.n))
    eta = eta_from_refrn(rn, rec.inside)
    n_eff = torch.where(rec.inside[:, None], -rec.n, rec.n)
    d_refr = normalize(refract(d, n_eff, eta))
    new_d = torch.where((branch == 0)[:, None], d_diff,
                        torch.where((branch == 1)[:, None], d_refl, d_refr))
    new_f = rec.color * f
    if debias_roulette:
        allp = dp + rp + rr
        bp = torch.where(branch == 0, dp,
                         torch.where(branch == 1, rp, rr)) / torch.where(
                             allp > 0, allp, 1.0)
        new_f = new_f / torch.where(bp > 1e-8, bp, 1.0)[:, None]
    return new_d, new_f


def static_segment(scene: Scene, fetch_mat, draws, carry,
                   debias_roulette: bool = False, newton_fn=None):
    """One segment of the static walk: intersect, record a deposit, roulette
    one continuation.

    ``carry`` = (org, dir, flux, alive), the JAX walk's scan carry.
    Returns (new carry, deposit record (pos, n, flux, valid)).
    """
    o, d, f, alive = carry
    rec = intersect_scene(scene, o, d, newton_fn=newton_fn)
    obj = torch.clamp(rec.obj_id, 0, scene.n_objects - 1)
    dp, rp, rr, isd, rn = fetch_mat(obj)
    hit = rec.hit & alive
    record = (rec.pos, rec.n, f, hit & isd)
    new_d, new_f = _continue(draws, rec, d, f, dp, rp, rr, rn, debias_roulette)
    return (rec.pos, new_d, new_f, hit), record


def regen_state_init(n_lights: int, n_photons: int, device="cpu"):
    """Cold-start walk state (org, dir, flux, alive, depth, rr_offset):
    all lanes dead, so the first segment emits a full batch."""
    N = n_lights * n_photons
    z3 = torch.zeros((N, 3), dtype=torch.float32, device=device)
    return (z3, torch.ones((N, 3), dtype=torch.float32, device=device), z3,
            torch.zeros((N,), dtype=torch.bool, device=device),
            torch.zeros((N,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def photon_trace_regen(scene: Scene, rng, light_pos: torch.Tensor,
                       light_color: torch.Tensor, n_photons: int, state,
                       max_depth: int = MAX_DEPTH,
                       debias_roulette: bool = False, newton_fn=None):
    """Walk ``max_depth + 1`` segments of L * n_photons persistent lanes.

    ``rng``: a ``torch.Generator`` on the lights' device, or a draws source
    (``core.sampling``).  ``state``: from the previous round, or None.

    Returns (Deposits of capacity (max_depth + 1) * N, new state, emitted):
    ``emitted`` is the (L,) float32 count of photons emitted per light this
    call; refills are assigned to lights round-robin over the global refill
    stream, so per-light counts stay equal to within one photon.
    """
    draws = as_draws(rng)
    dev = light_pos.device
    L = light_pos.shape[0]
    segs = max_depth + 1
    if state is None:
        state = regen_state_init(L, n_photons, dev)
    fetch_mat = _material_lanes(scene)

    carry = tuple(state) + (torch.zeros((L,), dtype=torch.float32, device=dev),)
    records = []
    for _ in range(segs):
        carry, rec = regen_segment(scene, fetch_mat, draws, light_pos,
                                   light_color, carry, segs,
                                   debias_roulette, newton_fn)
        records.append(rec)
    *state, emitted = carry
    pos, n, flux, valid = (torch.cat(x, 0) for x in zip(*records))
    deps = Deposits(pos=pos, n=n, flux=flux, valid=valid)
    return deps, tuple(state), emitted


def regen_segment(scene: Scene, fetch_mat, draws, light_pos: torch.Tensor,
                  light_color: torch.Tensor, carry, segs: int,
                  debias_roulette: bool = False, newton_fn=None):
    """One segment of the walk: refill dead lanes, intersect, record a
    deposit, roulette one continuation.

    ``carry`` = (org, dir, flux, alive, depth, rr_offset, emitted), the JAX
    walk's scan carry; ``fetch_mat`` from :func:`_material_lanes`.  Returns
    (new carry, deposit record (pos, n, flux, valid)).
    """
    o, d, f, alive, depth, rr_off, emitted = carry
    L = light_pos.shape[0]
    N = o.shape[0]
    # Refill dead lanes with fresh photons, lights assigned round-robin.
    need = ~alive
    n_need = need.sum(dtype=torch.int32)
    z = draws.uniform((N,), -1.0, 1.0)
    phi = draws.uniform((N,), 0.0, TWO_PI)
    ed = uniform_sphere(z, phi)                            # Light.h:9 law
    if L == 1:
        eo = light_pos[0].expand(N, 3)
        ef = (light_color[0] * (4.0 * math.pi)).expand(N, 3)
        emitted = emitted + n_need.to(torch.float32)[None]
    else:
        rank = torch.cumsum(need.to(torch.int32), 0) - 1
        lid = (rr_off + torch.clamp_min(rank, 0)) % L
        oh = onehot_f32(lid, L) * need.to(torch.float32)[:, None]
        eo = take_rows(light_pos, lid)
        ef = take_rows(light_color, lid) * (4.0 * math.pi)
        emitted = emitted + oh.sum(0)
    nd = need[:, None]
    o = torch.where(nd, eo, o)
    d = torch.where(nd, ed, d)
    f = torch.where(nd, ef, f)
    depth = torch.where(need, 0, depth)
    rr_off = (rr_off + n_need) % L

    rec = intersect_scene(scene, o, d, newton_fn=newton_fn)
    obj = torch.clamp(rec.obj_id, 0, scene.n_objects - 1)
    dp, rp, rr, isd, rn = fetch_mat(obj)
    record = (rec.pos, rec.n, f, rec.hit & isd)
    new_d, new_f = _continue(draws, rec, d, f, dp, rp, rr, rn, debias_roulette)

    depth = depth + 1
    alive = rec.hit & (depth < segs)
    return (rec.pos, new_d, new_f, alive, depth, rr_off, emitted), record


def compact_deposits(dep: Deposits, capacity: int) -> Deposits:
    """The valid deposits of ``dep`` in their order, gathered into a buffer
    of ``capacity`` records (invalid fill); valid ones beyond it are left
    out, and the caller counts them.  ``dep`` itself when it fits."""
    D = dep.valid.shape[0]
    if capacity >= D:
        return dep
    idx = compact_indices(dep.valid, capacity, fill=D)
    ok = idx < D
    safe = torch.clamp_max(idx, D - 1)
    return Deposits(pos=dep.pos[safe], n=dep.n[safe], flux=dep.flux[safe],
                    valid=dep.valid[safe] & ok)
