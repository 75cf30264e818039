"""Holding a run of the walks to a reference run, one segment at a time.

The eye and photon walks are chaotic.  A float32 operation rounded another
way moves a hit by an ulp; the next bounce off a sphere or the teapot
amplifies the difference, and within a few segments a path takes another
decision.  Two correct implementations, or one compiled two ways, therefore
drift apart when they run free: the JAX package's jitted pass and the same
pass with its walk steps recorded by host callbacks differ in
``photons_emitted`` and by ~5% in image L1 at 32 x 32 (measured on the CPU).

So a run under test is compared with a reference run segment by segment.
:func:`pinned_segments` replaces ``render.eye.eye_segment`` (both eye
wavefronts), ``render.photon.regen_segment`` and
``render.photon.static_segment`` with wrappers that, for each call,

1. check the segment's input against the reference's input for that segment
   (discrete fields exactly; floats to the tolerances below, since the
   camera rays of the first segment are computed on both sides);
2. run the real segment on the reference's input;
3. compare its output with the reference's output lane by lane;
4. return the reference's output, so the next segment again starts from the
   reference's state.

The reference's values are handed on without cutting the run's autograd
graph: a float tensor that carries a graph becomes ``ref + (x - x)``, with
the value of the reference and the gradient of the run's own ``x``
(:func:`pin`).  So a held run's gradients are the run's own, taken along
the reference's path.

Every decision must agree exactly: hit or miss, diffuse record, continuation,
refill, depth, drop and emission counters, and the pixel of each hit point.
Floats agree to the tolerances below.  Two classes of lanes have looser
bounds, and a lane held to one is checked to belong to it (by the
reference's hit, or for self-hits by either side's):

* far-field hits, beyond ``FAR_FIELD``, outside the room (its planes are
  unbounded and its front is open, so photons that leave it travel down
  the walls' extensions, up to 1e6 away): they meet the walls at grazing
  angles, which magnify a last-bit difference in the direction into a
  larger one in the hit point, and their texture colour is looked up at
  that point;
* self-hits, within ``SELF_HIT`` of the origin: a ray that leaves a surface
  and meets it again at once (the teapot next to where it left; a wall
  reached from behind, whose stored normal sends the bounce back through
  it).  On the teapot, Newton accepts a root once the residual is below
  sqrt(M_EPS) = 0.01, and next to the origin it converges slowly, so both
  sides' roots are only good to that: the point, its normal, the
  continuation and the texture colour (the teapot's lookup takes v = t, a
  reference quirk) differ accordingly.  On a sphere, the self-hit root of a
  ray leaving the surface is rounding noise next to the M_EPS margin, so
  one side may take it and the other not: a lane where one side hits within
  ``FLIP_T`` of the origin and the two sides then differ in a decision or
  in the surface hit is left out of the segment's checks and counted as a
  ``self-hit flip``, since the reference's output goes on.  A run's callers
  bound that count; a lane that differs with a self-hit farther out than
  ``FLIP_T`` is a mismatch.

A reference is a list of ``(input, output)`` pairs per walk, in the port's
calling convention: for ``eye_segment`` ``(lanes, (lanes, n_dropped,
rows))``, for ``regen_segment`` and ``static_segment`` ``(carry, (carry,
record))``.  A reference may leave the normal of a hit-point row that
stores nothing unknown (NaN); it is then not compared.
:func:`recording_segments` records one from a run of the port.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass, field

import torch

from .core.vecmath import M_EPS

# Tolerances.  "Seen" is the largest deviation of the port on the CPU from
# the JAX package over six walk rounds (one and two lights), the eye pass
# and the 32 x 32 pass of tests/test_torch_*.py.

#: Hit positions, relative to |origin| + t: sphere roots lose digits at
#: grazing incidence (r^2 - |L|^2 + proj^2 cancels), Newton roots converge
#: to ~1e-5 relative.  Seen: 7.5e-6.
POS_RTOL = 3e-5
#: Normals: the teapot's come from the Newton (u, v).  Seen: 4.9e-4.
NORMAL_ATOL = 2e-3
#: Continuation directions follow the normals.  Seen: 3.7e-4.
DIR_ATOL = 2e-3
#: A colour multiply (photon flux, hit-point weight), relative to the lane's
#: largest channel: texture lookups at points that agree to POS_RTOL.
#: Seen: 2.5e-4.
COLOR_RTOL = 2e-3
#: Hits farther than this from the world origin lie outside the room
#: (x in [1, 99], y in [0, 81.6], z in [0, ~250]).
FAR_FIELD = 1e3
#: Their position and colour bounds.  Seen: 3.8e-5 and 2.2e-3.
FAR_POS_RTOL = 1e-3
FAR_COLOR_RTOL = 5e-2
#: Hits closer than this to the origin are self-hits: 10 x sqrt(M_EPS).
SELF_HIT = 0.1
#: Their bounds: the point to the Newton acceptance radius sqrt(M_EPS); the
#: normal and the continuation to that times the teapot's largest curvature
#: (~5 / unit, at the spout); the colour, relative.  Seen: 2.1e-5 x
#: (|origin| + t), 1.6e-2, 6.7e-3 and 1.8e-7.
SELF_POS_ATOL = 1e-2
SELF_NORMAL_ATOL = 5e-2
SELF_COLOR_RTOL = 0.5
#: A self-hit this close to the origin may be taken by one side only: for a
#: ray leaving a sphere, r^2 - (|L|^2 - proj^2) cancels to a few ulps of r^2
#: (~3e-5 at r = 16.5), so the near root is noise of order M_EPS.  Seen: a
#: root at 1.22 M_EPS taken by JAX and not by the port (one lane, 32 x 32
#: pass).
FLIP_T = 10 * M_EPS
#: Self-hit flips a held run of the tests' size (up to 32 x 32 pixels and
#: 2 x 1024 photons) may show.  Seen: 1 (JAX vs port), 0 (card vs CPU).
MAX_FLIPS = 1


class SegmentMismatch(AssertionError):
    """A segment's output left the tolerances of its reference."""


@dataclass
class Report:
    """What the pinned run saw: segments compared, the largest deviation per
    field (relative for positions and colours, absolute for normals and
    directions) and per class of lanes, and how many lane comparisons fell
    in each class."""
    segments: dict = field(default_factory=lambda: {"eye": 0, "photon": 0})
    max_err: dict = field(default_factory=dict)
    lanes: dict = field(default_factory=dict)

    def note(self, name: str, err: torch.Tensor) -> None:
        if err.numel():
            self.max_err[name] = max(self.max_err.get(name, 0.0), float(err.max()))


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    return type(x)(_to(v, device) for v in x)


def pin(got, ref):
    """``ref``'s value with ``got``'s autograd graph: for a float tensor
    that carries a graph, ``ref + (g - g)`` with g = ``got`` where finite
    (the value is ``ref`` exactly, the gradient ``got``'s); otherwise
    ``ref``.  Recurses into tuples."""
    if isinstance(got, torch.Tensor):
        if not got.requires_grad:
            return ref
        g = torch.where(torch.isfinite(got), got, 0.0)
        return ref + (g - g.detach())
    return type(ref)(pin(x, r) for x, r in zip(got, ref))


def _lane_max(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax(-1) if x.dim() > 1 else x.abs()


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return _lane_max(got - want) / torch.clamp_min(_lane_max(want), 1e-30)


def _where(mask: torch.Tensor) -> list:
    return torch.nonzero(mask).flatten()[:8].tolist()


def _exact(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    bad = got != want
    if bad.dim() > 1:
        bad = bad.any(-1)
    if bool(bad.any()):
        raise SegmentMismatch(f"{what}: {int(bad.sum())} lanes differ, "
                              f"first {_where(bad.reshape(-1))}")


def _close(report: Report, what: str, err: torch.Tensor, mask: torch.Tensor,
           tol, classes=()) -> None:
    """Per-lane ``err`` within ``tol`` on the lanes of ``mask``.  A lane in
    one of ``classes`` ((name, lanes, tolerance), first match wins) is held
    to that class's tolerance instead; tolerances are floats or per-lane."""
    err = err.detach()
    limit = torch.as_tensor(tol, dtype=err.dtype, device=err.device).expand_as(err)
    plain = mask.clone()
    for name, lanes, cls_tol in classes:
        lanes = lanes & plain
        plain &= ~lanes
        limit = torch.where(lanes, cls_tol, limit)
        report.note(f"{what} ({name})", err[lanes])
        report.lanes[name] = report.lanes.get(name, 0) + int(lanes.sum())
    report.note(what, err[plain])
    bad = mask & (err > limit)
    if bool(bad.any()):
        raise SegmentMismatch(f"{what}: {int(bad.sum())} lanes beyond tolerance, "
                              f"first {_where(bad)}, largest {float(err[bad].max()):.3g}")


def _hit_checks(report: Report, walk: str, origin, got_pos, got_n, want_pos,
                want_n, decisions, live) -> tuple:
    """Decisions and hits of one segment.

    ``decisions``: (name, got, want) per-lane flags that must agree exactly,
    except on a lane that hits within ``FLIP_T`` on either side and whose
    two sides then took different paths (another decision, or another
    surface): there the self-hit root straddles M_EPS on one side and not
    on the other, and the lane is left out of every check (``self-hit
    flip`` in the report).  A lane neither side keeps (every decision
    false on both) is never compared and never counts as a flip.  Positions and normals are held on the other
    ``live`` lanes.  Returns the lanes held and their far-field and
    self-hit classes."""
    t, t_got = _norm(want_pos - origin), _norm(got_pos - origin)
    near = (t < SELF_HIT) | (t_got < SELF_HIT)
    differ = _lane_max(got_pos - want_pos) > SELF_POS_ATOL
    for _, got, want in decisions:
        differ |= got != want
    # A lane that neither side keeps (no decision taken on either) is not
    # compared at all, so it cannot flip.
    kept = torch.zeros_like(differ)
    for _, got, want in decisions:
        kept |= got | want
    flip = (torch.minimum(t, t_got) < FLIP_T) & differ & kept
    report.lanes["self-hit flip"] = report.lanes.get("self-hit flip", 0) + int(flip.sum())
    for what, got, want in decisions:
        _exact(f"{walk} {what}", got[~flip], want[~flip])
    held = live & ~flip
    far = _lane_max(want_pos) > FAR_FIELD
    self_hit = near & ~flip
    scale = _norm(origin) + t
    _close(report, f"{walk} position", _lane_max(got_pos - want_pos) / scale, held,
           POS_RTOL, [("self-hit", self_hit, SELF_POS_ATOL / scale),
                      ("far field", far, FAR_POS_RTOL)])
    known = torch.isfinite(want_n).all(-1)
    _close(report, f"{walk} normal", _lane_max(got_n - torch.where(known[:, None], want_n, 0.0)),
           held & known, NORMAL_ATOL, [("self-hit", self_hit, SELF_NORMAL_ATOL)])
    return ~flip, far, self_hit


def _colour_classes(far, self_hit) -> list:
    return [("far field", far, FAR_COLOR_RTOL), ("self-hit", self_hit, SELF_COLOR_RTOL)]


def check_eye_input(got, want, report: Report) -> None:
    o, d, wgt, px, act = want
    _exact("eye input pixel", got[3], px)
    _exact("eye input active", got[4], act)
    _close(report, "eye input origin",
           _lane_max(got[0] - o) / torch.clamp_min(_norm(o), 1.0), act, POS_RTOL)
    _close(report, "eye input direction", _lane_max(got[1] - d), act, DIR_ATOL)
    _close(report, "eye input weight", _rel(got[2], wgt), act, COLOR_RTOL)


def check_eye_segment(lanes_in, got, want, report: Report) -> None:
    """One eye segment run on ``lanes_in`` against the reference's output."""
    (g_lanes, g_drop, g_rows), (w_lanes, w_drop, w_rows) = got, want
    _exact("eye secondaries dropped", g_drop, w_drop)
    _exact("eye pixel", g_lanes[3], w_lanes[3])
    _exact("eye hit-point pixel", g_rows[:, 9], w_rows[:, 9])
    valid = w_rows[:, 10] > 0.5
    held, far, self_hit = _hit_checks(
        report, "eye", lanes_in[0], g_rows[:, 0:3], g_rows[:, 3:6], w_rows[:, 0:3],
        w_rows[:, 3:6], [("hit point", g_rows[:, 10] > 0.5, valid),
                         ("continuation", g_lanes[4], w_lanes[4])],
        valid | w_lanes[4])
    _close(report, "eye hit-point weight", _rel(g_rows[:, 6:9], w_rows[:, 6:9]),
           valid & held, COLOR_RTOL, _colour_classes(far, self_hit))
    _close(report, "eye direction", _lane_max(g_lanes[1] - w_lanes[1]),
           w_lanes[4] & held, DIR_ATOL, [("self-hit", self_hit, SELF_NORMAL_ATOL)])
    _close(report, "eye continuation weight", _rel(g_lanes[2], w_lanes[2]),
           w_lanes[4] & held, COLOR_RTOL, _colour_classes(far, self_hit))


def check_photon_input(got, want, report: Report) -> None:
    o, d, f, alive, depth, rr_off, emitted = want
    for what, i in (("alive", 3), ("depth", 4), ("refill offset", 5), ("emitted", 6)):
        _exact(f"photon input {what}", got[i], want[i])
    _close(report, "photon input origin",
           _lane_max(got[0] - o) / torch.clamp_min(_norm(o), 1.0), alive, POS_RTOL)
    _close(report, "photon input direction", _lane_max(got[1] - d), alive, DIR_ATOL)
    _close(report, "photon input flux", _rel(got[2], f), alive, COLOR_RTOL)


def check_photon_segment(carry_in, light_pos, got, want, report: Report) -> None:
    """One photon segment run on ``carry_in`` against the reference's
    output."""
    (g_carry, g_rec), (w_carry, w_rec) = got, want
    for what, i in (("depth", 4), ("refill offset", 5), ("emitted", 6)):
        _exact(f"photon {what}", g_carry[i], w_carry[i])
    _exact("photon deposit flux", g_rec[2], w_rec[2])
    # Where each lane started: refilled lanes at their light (round-robin).
    o, _, _, alive, _, rr_off, _ = carry_in
    need = ~alive
    rank = torch.clamp_min(torch.cumsum(need.to(torch.int64), 0) - 1, 0)
    lid = (rr_off.to(torch.int64) + rank) % light_pos.shape[0]
    origin = torch.where(need[:, None], light_pos[lid], o)
    held, far, self_hit = _hit_checks(
        report, "photon", origin, g_rec[0], g_rec[1], w_rec[0], w_rec[1],
        [("deposit valid", g_rec[3], w_rec[3]), ("alive", g_carry[3], w_carry[3])],
        w_rec[3] | w_carry[3])
    _close(report, "photon direction", _lane_max(g_carry[1] - w_carry[1]),
           w_carry[3] & held, DIR_ATOL, [("self-hit", self_hit, SELF_NORMAL_ATOL)])
    _close(report, "photon flux", _rel(g_carry[2], w_carry[2]), w_carry[3] & held,
           COLOR_RTOL, _colour_classes(far, self_hit))


def check_static_input(got, want, report: Report) -> None:
    o, d, f, alive = want
    _exact("static photon input alive", got[3], alive)
    _close(report, "static photon input origin",
           _lane_max(got[0] - o) / torch.clamp_min(_norm(o), 1.0), alive, POS_RTOL)
    _close(report, "static photon input direction", _lane_max(got[1] - d), alive, DIR_ATOL)
    _close(report, "static photon input flux", _rel(got[2], f), alive, COLOR_RTOL)


def check_static_segment(carry_in, got, want, report: Report) -> None:
    """One static-walk segment run on ``carry_in`` against the reference's
    output."""
    (g_carry, g_rec), (w_carry, w_rec) = got, want
    _exact("static photon deposit flux", g_rec[2], w_rec[2])
    held, far, self_hit = _hit_checks(
        report, "static photon", carry_in[0], g_rec[0], g_rec[1], w_rec[0], w_rec[1],
        [("deposit valid", g_rec[3], w_rec[3]), ("alive", g_carry[3], w_carry[3])],
        w_rec[3] | w_carry[3])
    _close(report, "static photon direction", _lane_max(g_carry[1] - w_carry[1]),
           w_carry[3] & held, DIR_ATOL, [("self-hit", self_hit, SELF_NORMAL_ATOL)])
    _close(report, "static photon flux", _rel(g_carry[2], w_carry[2]), w_carry[3] & held,
           COLOR_RTOL, _colour_classes(far, self_hit))


def _walks():
    """Each walk's segment function: walk -> (module, name, argument held,
    input check, output check).  The output check takes the call's bound
    arguments, the reference input, the run's output and the reference
    output."""
    from .render import eye, photon

    return {
        "eye": (eye, "eye_segment", "lanes", check_eye_input,
                lambda a, r_in, got, r_out, rep: check_eye_segment(r_in, got, r_out, rep)),
        "photon": (photon, "regen_segment", "carry", check_photon_input,
                   lambda a, r_in, got, r_out, rep: check_photon_segment(
                       r_in, a["light_pos"], got, r_out, rep)),
        "static": (photon, "static_segment", "carry", check_static_input,
                   lambda a, r_in, got, r_out, rep: check_static_segment(r_in, got, r_out, rep)),
    }


@contextlib.contextmanager
def _patched(wrappers: dict):
    """Within the block, each walk's segment function is ``wrappers[walk]
    (the real function)``."""
    walks = _walks()
    real = {w: getattr(walks[w][0], walks[w][1]) for w in wrappers}
    for w, make in wrappers.items():
        setattr(walks[w][0], walks[w][1], make(real[w]))
    try:
        yield
    finally:
        for w, fn in real.items():
            setattr(walks[w][0], walks[w][1], fn)


@contextlib.contextmanager
def pinned_segments(eye_steps=None, photon_steps=None, static_steps=None):
    """Within the block, every eye / regen photon / static photon segment of
    the port is held to the next step of ``eye_steps`` / ``photon_steps`` /
    ``static_steps`` (see the module note) and hands on the reference's
    output, pinned to the run's graph (:func:`pin`).  Yields a
    :class:`Report`; a walk left unpinned (None) runs as usual."""
    report = Report()
    walks = _walks()

    def pinner(walk, steps):
        _, _, held, check_in, check_out = walks[walk]
        it = iter(steps)

        def make(fn):
            sig = inspect.signature(fn)

            def pinned(*args, **kw):
                a = sig.bind(*args, **kw).arguments
                try:
                    ref_in, ref_out = next(it)
                except StopIteration:
                    raise SegmentMismatch(f"the run has more {walk} segments than "
                                          "its reference") from None
                device = a[held][0].device
                ref_in, ref_out = _to(ref_in, device), _to(ref_out, device)
                check_in(a[held], ref_in, report)
                a[held] = pin(a[held], ref_in)
                got = fn(**a)
                check_out(a, ref_in, got, ref_out, report)
                report.segments[walk] = report.segments.get(walk, 0) + 1
                return pin(got, ref_out)
            return pinned
        return make

    given = {"eye": eye_steps, "photon": photon_steps, "static": static_steps}
    with _patched({w: pinner(w, st) for w, st in given.items() if st is not None}):
        yield report


@contextlib.contextmanager
def recording_segments():
    """Within the block, record every eye, regen photon and static photon
    segment of the port as (input, output) on the CPU.  Yields {"eye":
    [...], "photon": [...], "static": [...]}."""
    steps = {w: [] for w in _walks()}

    def recorder(walk):
        held = _walks()[walk][2]

        def make(fn):
            sig = inspect.signature(fn)

            def recording(*args, **kw):
                a = sig.bind(*args, **kw).arguments
                out = fn(**a)
                steps[walk].append((_to(a[held], "cpu"), _to(out, "cpu")))
                return out
            return recording
        return make

    with _patched({w: recorder(w) for w in steps}):
        yield steps
