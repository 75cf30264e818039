"""PASS 1 - eye trace: the staged-width wavefront emitting SPPM hit points.

Port of ``raytrace3_tpu/render/eye.py``: diffuse lobes store hit points,
and specular lobes continue.  Two schedules:

* the slot wavefront (``eye_pass`` with no schedule): K = ``slots`` lanes a
  pixel walk every segment.  A hit that needs both a reflected and a
  refracted continuation takes a free slot of its pixel for the second
  (a stable partition of the 2K candidates into K slots); at K = 1 every
  lane keeps its one continuation.  Each segment's hit points scatter into
  the buffer at once, so autograd reaches their weights;
* the staged-width wavefront (``_eye_pass_compact``, one slot a pixel): at
  each scheduled segment the surviving rays are gathered into a narrower
  buffer, and the hit points scatter once at the end.

A continuation that finds no slot, a ray beyond a stage's width and a hit
point beyond the buffer are dropped and counted in ``dropped``.
"""

from __future__ import annotations

import torch

from ..core.types import HitPoints, eta_from_refrn, make_hitpoints
from ..core.vecmath import normalize, reflect, refract
from ..geometry.scene import Scene, intersect_scene
from ..ops.compact import compact_indices
from ..ops.onehot import take_rows

#: Reference max trace depth (Raytracer.h:12).
MAX_DEPTH = 13
#: Reference initial gather radius^2 (Raytracer.h:13).
INIT_R2 = 2.0


def _eye_material_lanes(scene: Scene):
    """Per-lane fetch of [is_diff, is_refl, is_refr, diff, refl, refr,
    refrn] from one (N, 13) material table."""
    m = scene.materials
    tbl = torch.cat([
        m.is_diff().to(torch.float32)[:, None],
        m.is_refl().to(torch.float32)[:, None],
        m.is_refr().to(torch.float32)[:, None],
        m.diff, m.refl, m.refr, m.refrn[:, None],
    ], 1)

    def fetch(obj):
        t = take_rows(tbl, obj)                           # (R, 13)
        return (t[:, 0] > 0.5, t[:, 1] > 0.5, t[:, 2] > 0.5,
                t[:, 3:6], t[:, 6:9], t[:, 9:12], t[:, 12])

    return fetch


def eye_stage_widths(n_rays: int, schedule: tuple,
                     max_depth: int = MAX_DEPTH) -> list[tuple[int, int]]:
    """(segments, lane width) per stage of a compact schedule: each width
    is ``int(n_rays * frac)`` rounded DOWN to a multiple of 128 lanes (at
    least 128; JAX's expression, whose docstring says up), and never
    exceeds the incoming width."""
    segs_total = max_depth + 1
    bounds = [0] + [seg for seg, _ in schedule] + [segs_total]
    widths = [n_rays]
    for _, f in schedule:
        w = max(128, -(-int(n_rays * f)) // 128 * 128)
        widths.append(min(w, widths[-1]))
    return [(hi - lo, w)
            for lo, hi, w in zip(bounds[:-1], bounds[1:], widths)]


def eye_pass(scene: Scene, org: torch.Tensor, dir: torch.Tensor,
             capacity: int, max_depth: int = MAX_DEPTH, slots: int = 1,
             init_r2: float = INIT_R2, newton_fn=None, pixel_offset: int = 0,
             compact_schedule: tuple = ()):
    """Trace camera rays; return (HitPoints, {"count", "dropped"}).

    ``slots``: K ray slots a pixel (K = 1 suffices for scenes whose
    materials have at most one specular lobe, every reference scene).
    ``compact_schedule``: ((segment, frac), ...): at the start of each
    listed segment (>= 1) the surviving rays are gathered into a buffer of
    about ``frac * R`` lanes (:func:`eye_stage_widths`); it needs ``slots=1``.  Empty:
    the slot wavefront.
    """
    if compact_schedule:
        if slots != 1:
            raise ValueError("compact_schedule requires slots=1")
        return _eye_pass_compact(scene, org, dir, capacity, max_depth,
                                 init_r2, newton_fn, pixel_offset,
                                 compact_schedule)
    return _eye_pass_slots(scene, org, dir, capacity, max_depth, init_r2,
                           newton_fn, pixel_offset, slots)


def eye_segment(scene: Scene, fetch_mat, lanes, newton_fn=None, slots: int = 1):
    """One segment of either eye wavefront.

    ``lanes`` = (org, dir, wgt, pixel, active), the lanes of the JAX pass's
    scan carry, pixel-major with ``slots`` lanes a pixel; ``fetch_mat``
    from :func:`_eye_material_lanes`.  Returns (next lanes, continuations
    dropped, hit-point candidate rows (w, 11), one a lane: pos3 | n3 |
    wgt3 | pixel | valid, pixel in f32 being exact below 2^24).

    At ``slots`` = 1 each lane keeps its primary continuation (the
    reflection, else the refraction) and a second one is dropped.  At K >
    1 a pixel's K primaries and K refractions that coexist with a
    reflection are stably partitioned, valid first, into its K slots
    (eye.py:186-212); the valid ones that find no slot are dropped.
    """
    o, d, wgt, px, act = lanes
    dtype = o.dtype
    rec = intersect_scene(scene, o, d, newton_fn=newton_fn)
    obj = torch.clamp(rec.obj_id, 0, scene.n_objects - 1)
    isd, isl, isr, m_diff, m_refl, m_refr, rn = fetch_mat(obj)
    hit = rec.hit & act

    diff_v = hit & isd
    rows = torch.cat([rec.pos, rec.n, rec.color * wgt * m_diff,
                      px.to(dtype)[:, None], diff_v.to(dtype)[:, None]], 1)

    refl_v = hit & isl
    refr_v = hit & isr
    d_refl = normalize(reflect(d, rec.n))
    w_refl = rec.color * wgt * m_refl
    eta = eta_from_refrn(rn, rec.inside)
    n_eff = torch.where(rec.inside[:, None], -rec.n, rec.n)
    d_refr = normalize(refract(d, n_eff, eta))
    w_refr = rec.color * wgt * m_refr

    prim_v = refl_v | refr_v
    prim_d = torch.where(refl_v[:, None], d_refl, d_refr)
    prim_w = torch.where(refl_v[:, None], w_refl, w_refr)
    sec_v = refl_v & refr_v
    if slots == 1:
        return (rec.pos, prim_d, prim_w, px, prim_v), sec_v.sum(dtype=torch.int32), rows

    R = o.shape[0] // slots
    pair = lambda a, b: torch.cat([a.reshape(R, slots, *a.shape[1:]),
                                   b.reshape(R, slots, *b.shape[1:])], 1)
    cand_v = pair(prim_v, sec_v)                               # (R, 2K)
    order = torch.argsort((~cand_v).to(torch.int8), dim=1, stable=True)[:, :slots]
    take = lambda c: torch.take_along_dim(
        c, order.reshape(R, slots, *(1,) * (c.dim() - 2)), 1).reshape(R * slots,
                                                                      *c.shape[2:])
    act = take(cand_v)
    n_dropped = (cand_v.sum(dtype=torch.int32) - act.sum(dtype=torch.int32))
    return ((take(pair(rec.pos, rec.pos)), take(pair(prim_d, d_refr)),
             take(pair(prim_w, w_refr)), px, act), n_dropped, rows)


def _primary_lanes(org, dir, pixel_offset, slots: int = 1):
    """Each pixel's camera ray in its first of ``slots`` lanes; the other
    lanes idle (zero origin, direction and weight) until a split fills
    them."""
    R = org.shape[0]
    dtype, dev = org.dtype, org.device
    px = torch.arange(R, dtype=torch.int32, device=dev) + pixel_offset
    if slots == 1:
        return (org, dir, torch.ones((R, 3), dtype=dtype, device=dev), px,
                torch.ones((R,), dtype=torch.bool, device=dev))
    pad = lambda x: torch.cat([x[:, None], torch.zeros((R, slots - 1, 3), dtype=dtype,
                                                       device=dev)], 1).reshape(R * slots, 3)
    act = torch.zeros((R, slots), dtype=torch.bool, device=dev)
    act[:, 0] = True
    return (pad(org), pad(dir), pad(torch.ones((R, 3), dtype=dtype, device=dev)),
            px.repeat_interleave(slots), act.reshape(R * slots))


def _hitpoints(buf, capacity, init_r2):
    """HitPoints from a (capacity, 11) buffer of candidate rows."""
    return make_hitpoints(capacity, init_r2, buf.device, buf.dtype).replace(
        pos=buf[:, 0:3], n=buf[:, 3:6], wgt=buf[:, 6:9],
        pixel=buf[:, 9].to(torch.int32), valid=buf[:, 10] > 0.5)


def _eye_pass_slots(scene, org, dir, capacity, max_depth, init_r2,
                    newton_fn, pixel_offset, slots: int = 1):
    """The slot wavefront at ``slots`` lanes a pixel (eye.py:120-218):
    every segment's hit points go to the next free buffer slots in lane
    order (Raytracer.h:312-319); once the buffer is full the rest are
    dropped and counted.  The scatter is out of place, so every version of
    the buffer stays in the autograd graph."""
    dev = org.device
    fetch_mat = _eye_material_lanes(scene)
    lanes = _primary_lanes(org, dir, pixel_offset, slots)
    buf = torch.zeros((capacity + 1, 11), dtype=org.dtype, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_depth + 1):
        lanes, n_dropped, rows = eye_segment(scene, fetch_mat, lanes, newton_fn, slots)
        valid = rows[:, 10] > 0.5
        slot = count + torch.cumsum(valid.to(torch.int32), 0) - 1
        widx = torch.where(valid & (slot < capacity), slot, capacity).long()
        buf = buf.index_put((widx,), rows)     # row `capacity` takes the rest
        n_new = valid.sum(dtype=torch.int32)
        new_count = torch.clamp_max(count + n_new, capacity)
        dropped = dropped + n_dropped + (count + n_new - new_count)
        count = new_count
    return _hitpoints(buf[:capacity], capacity, init_r2), {"count": count,
                                                           "dropped": dropped}


def _eye_pass_compact(scene, org, dir, capacity, max_depth, init_r2,
                      newton_fn, pixel_offset, schedule):
    R = org.shape[0]
    dtype, dev = org.dtype, org.device
    fetch_mat = _eye_material_lanes(scene)

    lanes = _primary_lanes(org, dir, pixel_offset)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)

    segs_total = max_depth + 1
    prev = 0
    for seg, _ in schedule:
        if not (0 < seg < segs_total and seg > prev):
            raise ValueError(f"bad compact schedule {schedule}")
        prev = seg

    all_rows = []
    for n_segs, w in eye_stage_widths(R, schedule, max_depth):
        cur_w = lanes[0].shape[0]
        if w < cur_w:
            o, d, wgt, px, act = lanes
            n_act = act.sum(dtype=torch.int32)
            idx = compact_indices(act, w, fill=cur_w)
            ok = idx < cur_w
            lane_rows = torch.cat([o, d, wgt, px.to(dtype)[:, None],
                                   act.to(dtype)[:, None]], 1)[
                torch.clamp_max(idx, cur_w - 1)]                # (w, 11)
            lanes = (lane_rows[:, 0:3], lane_rows[:, 3:6], lane_rows[:, 6:9],
                     lane_rows[:, 9].to(torch.int32),
                     (lane_rows[:, 10] > 0.5) & ok)
            dropped = dropped + torch.clamp_min(n_act - w, 0)
        for _ in range(n_segs):
            lanes, n_dropped, rows = eye_segment(scene, fetch_mat, lanes,
                                                 newton_fn)
            dropped = dropped + n_dropped
            all_rows.append(rows)

    rows = torch.cat(all_rows, 0)                              # (K, 11)
    valid = rows[:, 10] > 0.5
    slot = torch.cumsum(valid.to(torch.int32), 0) - 1
    widx = torch.where(valid & (slot < capacity), slot, capacity).long()
    buf = torch.zeros((capacity + 1, 11), dtype=dtype, device=dev)
    buf[widx] = rows                       # row `capacity` takes the rest
    hp = _hitpoints(buf[:capacity], capacity, init_r2)
    n_valid = valid.sum(dtype=torch.int32)
    count = torch.clamp_max(n_valid, capacity)
    dropped = dropped + torch.clamp_min(n_valid - capacity, 0)
    return hp, {"count": count, "dropped": dropped}
