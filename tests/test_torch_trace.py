"""The pass's stage spans and its Bezier compaction tally (``utils/trace.py``).

A tiny ``full`` scene (the teapot in view) on the bench's path cut to size:
the regen walk, the staged eye schedule, Bezier compaction 0.09 / 0.05, the
tile deposit and the default solver, 16 x 16 pixels, 2 rounds of 256
photons, depth 5.

* Under ``torch.profiler`` one pass records each span as often as the
  pass runs its stage: ``rt3.eye``, ``rt3.prepare`` and ``rt3.estimate``
  once, ``rt3.walk`` and ``rt3.fold`` once a round.
* With no profiler the pass never enters ``record_function``.
* The image and every stat are bit for bit the same with spans on and off.
* A planted overflow: rays whose gated count exceeds the compaction's lanes
  read ``bezier_overflow`` = gated - lanes (counted by hand with
  ``slab_test``) and ``bezier_lanes_used`` = lanes.
* Outside a pass (no tally) ``intersect_bezier`` issues no search of its
  own and returns the same outputs; a tally folds any number of counts.
"""

from collections import Counter

import pytest
import torch

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu_torch.geometry.aabb import aabb_from_points, slab_test
from raytrace3_tpu_torch.geometry.bezier import intersect_bezier
from raytrace3_tpu_torch.ops.compact import compact_indices_keyed
from raytrace3_tpu_torch.ops.deposit_kernel import make_tile_deposit, world_bounds_from_scene
from raytrace3_tpu_torch.render.driver import (CAMERA_LOOK, CAMERA_POS, build_scene,
                                               make_pass_fn)
from raytrace3_tpu_torch.utils import trace
from raytrace3_tpu_torch.utils.config import RenderConfig

ROUNDS = 2
CFG = RenderConfig(scene="full", width=16, height=16, passes=1, rounds=ROUNDS,
                   photons_per_round=256, max_depth=5, atlas_res=16, hitpoint_factor=1.3,
                   bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
                   photon_regen=True, eye_compact_schedule=((1, 0.25), (4, 0.04)))
SPANS = {"rt3.eye": 1, "rt3.prepare": 1, "rt3.walk": ROUNDS, "rt3.fold": ROUNDS,
         "rt3.estimate": 1}
BOUNDS = ("x_lo", "x_hi", "y_lo", "y_hi")


def _profiled(fn):
    """(fn(), the names of the events a CPU profiler recorded), read from
    its raw results (building the per-event objects takes seconds)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, Counter(e.name() for e in prof.profiler.kineto_results.events())


def _raising(name):
    raise AssertionError(f"record_function({name!r}) entered with no profiler running")


@pytest.fixture(scope="module")
def scene():
    return build_scene(CFG, "cpu")


@pytest.fixture(scope="module")
def passes(scene):
    """The pass on one generator seed with no profiler (``record_function``
    made to raise) and under ``torch.profiler``: ((image, stats) off,
    (image, stats) on, span names counted)."""
    b = world_bounds_from_scene(scene, extra_points=[CAMERA_POS])
    fn = make_pass_fn(scene, CFG, CAMERA_POS, CAMERA_LOOK,
                      deposit_fn=make_tile_deposit(**{k: b[k] for k in BOUNDS}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _raising)
        off = fn(torch.Generator().manual_seed(0))
    on, names = _profiled(lambda: fn(torch.Generator().manual_seed(0)))
    return off, on, Counter({k: n for k, n in names.items() if k.startswith("rt3.")})


@pytest.mark.parametrize("name,calls", sorted(SPANS.items()))
def test_each_span_recorded_once_a_stage(passes, name, calls):
    assert passes[2][name] == calls


def test_no_other_program_span(passes):
    assert set(passes[2]) == set(SPANS)


def test_no_span_entered_without_a_profiler(passes, monkeypatch):
    """The pass ran (in the fixture) with ``record_function`` raising; the
    guard alone is what a span costs then."""
    monkeypatch.setattr(torch.profiler, "record_function", _raising)
    assert not torch.autograd._profiler_enabled()
    assert trace.span("rt3.eye") is trace.span("rt3.walk")
    with trace.span("rt3.eye"):
        pass
    img, stats = passes[0]
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0


def test_spans_change_nothing(passes):
    (img_off, st_off), (img_on, st_on) = passes[0], passes[1]
    assert torch.equal(img_off, img_on)
    assert set(st_off) == set(st_on) >= set(trace.BEZIER_COUNTERS)
    for k in st_off:
        assert torch.equal(torch.as_tensor(st_off[k]), torch.as_tensor(st_on[k])), k


def test_the_pass_reports_its_tally(passes):
    """Every segment of the eye and of each round compacts (``cap`` < rays):
    the lanes are positive and, at the cells' fractions, nothing overflows."""
    st = passes[0][1]
    lanes, used, over = (int(st[k]) for k in ("bezier_lanes", "bezier_lanes_used",
                                                "bezier_overflow"))
    assert lanes > 0 and 0 < used <= lanes and over == 0
    assert int(st["dropped"]) == 0 and int(st["deposits_dropped"]) == 0


def _teapot_rays(scene, n_in: int, n_out: int):
    """``n_in`` rays from the camera toward points inside the teapot's box,
    then ``n_out`` (at most ``n_in``) pointing away from it."""
    ctrl = scene.bezier.ctrl
    pmin, pmax = aabb_from_points(ctrl.reshape(ctrl.shape[0], 16, 3))
    lo, hi = pmin.amin(0), pmax.amax(0)
    g = torch.Generator().manual_seed(7)
    target = lo + (hi - lo) * torch.rand((n_in, 3), generator=g)
    org = torch.as_tensor(CAMERA_POS, dtype=torch.float32).expand(n_in + n_out, 3).clone()
    d_in = target - org[:n_in]
    d = torch.cat([d_in, -d_in[:n_out]])
    return org, d / d.norm(dim=1, keepdim=True), lo, hi


@pytest.mark.parametrize("frac,overflows", [(0.25, True), (0.75, False)])
def test_bezier_tally_counts_the_overflow(scene, frac, overflows):
    org, dir, lo, hi = _teapot_rays(scene, 32, 32)
    R = org.shape[0]
    gated = int(slab_test(org, dir, lo, hi).sum())
    cap = max(8, int(R * frac))
    assert gated == 32 and cap < R and (cap < gated) == overflows
    with trace.bezier_tally() as tally:
        intersect_bezier(org, dir, scene.bezier, compact_frac=frac)
    st = {k: int(v) for k, v in tally.fold("cpu").items()}
    assert tally.lanes == [cap]
    assert st == {"bezier_overflow": max(gated - cap, 0), "bezier_lanes_used": min(gated, cap),
                  "bezier_lanes": cap}


def test_no_reduction_outside_a_tally(scene):
    org, dir, _, _ = _teapot_rays(scene, 32, 32)
    call = lambda: intersect_bezier(org, dir, scene.bezier, compact_frac=0.25)
    with trace.bezier_tally():
        inside, n_inside = _profiled(call)
    outside, n_outside = _profiled(call)
    assert n_inside["aten::searchsorted"] == 1 and n_outside["aten::searchsorted"] == 0
    assert n_outside["aten::sum"] == n_inside["aten::sum"]
    for a, b in zip(inside, outside):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [0, 3, trace.BezierTally.CHUNK + 5])
def test_the_tally_folds_any_number_of_compactions(n):
    """Compactions of 10 rays, i % 7 of them gated, into 4 lanes: an empty
    tally folds to zeros, and one past a buffer chunk keeps every count."""
    tally = trace.BezierTally()
    for i in range(n):
        mask = torch.arange(10) < i % 7
        tally.add(compact_indices_keyed(mask, 4)[1], 4)
    gated = [i % 7 for i in range(n)]
    st = {k: int(v) for k, v in tally.fold("cpu").items()}
    assert st == {"bezier_overflow": sum(max(g - 4, 0) for g in gated),
                  "bezier_lanes_used": sum(min(g, 4) for g in gated), "bezier_lanes": 4 * n}


@pytest.mark.parametrize("gated", [
    [9, 7, 10],
    [0, 0, 0],
    [i % 7 for i in range(trace.BezierTally.CHUNK + 5)],
], ids=["overflow", "none", "past-a-chunk"])
def test_a_written_slot_folds_as_a_searched_key(gated):
    """The three counters fold the same whether a compaction's gated count
    comes from its sorted key (the op code's ``add``) or is written into
    its slot directly (as the card's compaction kernel writes it), into
    4 lanes of 10 rays each time; outside a tally there is no slot."""
    keyed, written = trace.BezierTally(), trace.BezierTally()
    for g in gated:
        keyed.add(compact_indices_keyed(torch.arange(10) < g, 4)[1], 4)
        written.slot(4, "cpu").fill_(g)
    assert trace.bezier_count_slot(4, "cpu") is None
    with trace.bezier_tally() as tally:
        trace.bezier_count_slot(4, "cpu").fill_(gated[0])
    assert tally.lanes == [4]
    want = {"bezier_overflow": sum(max(g - 4, 0) for g in gated),
            "bezier_lanes_used": sum(min(g, 4) for g in gated), "bezier_lanes": 4 * len(gated)}
    fold = lambda t: {k: int(v) for k, v in t.fold("cpu").items()}
    assert fold(keyed) == fold(written) == want
