"""Eye pass: the port's staged-width wavefront (``_eye_pass_compact``) and
slot wavefront (``eye_pass`` with no schedule, at 1 and 2 slots; the
K-slot one also on tests/test_eye_slots.py's mini scenes) vs the JAX package's on
``full`` at reference-camera rays, both with the Newton kernel contract at
8 restarts (JAX: the Pallas kernel in interpret mode).  The pass draws no
random numbers.

The walk is held to JAX's one segment at a time
(``raytrace3_tpu_torch.testing``): each of the port's segments runs on
JAX's lane state for that segment, every decision must agree exactly and
every float to the stated tolerances, lane by lane, and JAX's output is
carried on.  The compaction between stages and the hit-point scatter then
run on identical data, so the hit-point buffer and the counters must equal
JAX's exactly.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_util import jax_walk_steps, port_scene
from raytrace3_tpu import scenes as jscenes
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import eye as jeye
from raytrace3_tpu.render.camera import emit_rays as j_emit_rays

from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import eye
from raytrace3_tpu_torch.testing import (COLOR_RTOL, MAX_FLIPS, NORMAL_ATOL, POS_RTOL,
                                         pinned_segments)

#: The bench's schedule (bench.py:118), and one that clips survivors.
SCHEDULES = {"bench": ((1, 0.25), (4, 0.04), (6, 0.02)),
             "clipping": ((1, 0.1), (3, 0.05))}


@pytest.mark.parametrize("n_rays", [1024, 4096, 262144])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_stage_widths_match(n_rays, name):
    assert eye.eye_stage_widths(n_rays, SCHEDULES[name]) == \
        jeye.eye_stage_widths(n_rays, SCHEDULES[name])


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_eye_pass_compact_matches_jax(name):
    sched = SCHEDULES[name]
    js = jscenes.full(atlas_res=32).replace(bezier_compact_frac=0.09)
    org, d = j_emit_rays(jscenes.reference_camera(32, 32))
    cap = int(1024 * 1.3)
    with jax_walk_steps() as steps:
        hp_j, st_j = jax.jit(lambda o, dd: jeye.eye_pass(
            js, o, dd, cap, newton_fn=make_newton_pallas(interpret=True),
            compact_schedule=sched))(org, d)
        jax.block_until_ready(hp_j)
    assert len(steps["eye"]) == 14
    with pinned_segments(eye_steps=steps["eye"]) as report:
        hp_p, st_p = eye.eye_pass(port_scene(js), torch.as_tensor(np.array(org)),
                                  torch.as_tensor(np.array(d)), cap,
                                  newton_fn=make_newton(), compact_schedule=sched)
    print(f"{name}: count {int(st_p['count'])}, {report}")
    assert report.segments["eye"] == 14
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    assert int(st_j["count"]) > 500
    for k in ("count", "dropped"):
        assert int(st_p[k]) == int(st_j[k]), k
    if name == "clipping":
        assert int(st_p["dropped"]) > 0
    for f in ("pos", "n", "wgt", "pixel", "valid", "r2", "tao", "nphot"):
        np.testing.assert_array_equal(getattr(hp_p, f).numpy(),
                                      np.asarray(getattr(hp_j, f)), err_msg=f)


def test_eye_pass_slots_matches_jax():
    """The one-slot wavefront (JAX's ``K == 1`` branch), held segment by
    segment; the buffer then equals JAX's exactly, and autograd reaches the
    atlas through the per-segment scatter into the hit-point weights."""
    js = jscenes.full(atlas_res=32).replace(bezier_compact_frac=0.12)
    org, d = j_emit_rays(jscenes.reference_camera(24, 24))
    cap = int(576 * 1.5)
    with jax_walk_steps() as steps:
        hp_j, st_j = jax.jit(lambda o, dd: jeye.eye_pass(
            js, o, dd, cap, newton_fn=make_newton_pallas(interpret=True)))(org, d)
        jax.block_until_ready(hp_j)
    assert len(steps["eye"]) == 14
    ps = port_scene(js)
    ps.atlas.requires_grad_(True)
    with pinned_segments(eye_steps=steps["eye"]) as report:
        hp_p, st_p = eye.eye_pass(ps, torch.as_tensor(np.array(org)),
                                  torch.as_tensor(np.array(d)), cap, newton_fn=make_newton())
    print(f"slots: count {int(st_p['count'])}, {report}")
    assert report.segments["eye"] == 14
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    assert int(st_j["count"]) > 300
    for k in ("count", "dropped"):
        assert int(st_p[k]) == int(st_j[k]), k
    for f in ("pos", "n", "wgt", "pixel", "valid", "r2", "tao", "nphot"):
        np.testing.assert_array_equal(getattr(hp_p, f).detach().numpy(),
                                      np.asarray(getattr(hp_j, f)), err_msg=f)
    hp_p.wgt.sum().backward()
    g = ps.atlas.grad
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def _hold_k_slot_pass(res: int, newton: bool):
    """The slot wavefront at K = 2 on ``full`` at ``res``^2, held to JAX's
    segment by segment; with ``newton`` both sides solve Bezier hits with
    the Newton kernel contract at 8 restarts, else with ``solve_winner``.
    The second slot of each pixel stays idle (no reference material
    splits), so the lanes keep their slots and the buffer equals JAX's
    exactly."""
    js = jscenes.full(atlas_res=32).replace(bezier_compact_frac=0.12)
    org, d = j_emit_rays(jscenes.reference_camera(res, res))
    cap = int(res * res * 1.5)
    j_newton = make_newton_pallas(interpret=True) if newton else None
    with jax_walk_steps() as steps:
        hp_j, st_j = jax.jit(lambda o, dd: jeye.eye_pass(js, o, dd, cap, newton_fn=j_newton,
                                                         slots=2))(org, d)
        jax.block_until_ready(hp_j)
    assert len(steps["eye"]) == 14
    with pinned_segments(eye_steps=steps["eye"]) as report:
        hp_p, st_p = eye.eye_pass(port_scene(js), torch.as_tensor(np.array(org)),
                                  torch.as_tensor(np.array(d)), cap,
                                  newton_fn=make_newton() if newton else None, slots=2)
    print(f"2 slots at {res}^2: count {int(st_p['count'])}, {report}")
    assert report.segments["eye"] == 14
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    assert int(st_j["count"]) > {16: 150, 24: 300}[res]
    for k in ("count", "dropped"):
        assert int(st_p[k]) == int(st_j[k]), k
    for f in ("pos", "n", "wgt", "pixel", "valid", "r2", "tao", "nphot"):
        np.testing.assert_array_equal(getattr(hp_p, f).numpy(),
                                      np.asarray(getattr(hp_j, f)), err_msg=f)


def test_k_slot_eye_pass_matches_jax():
    """K = 2 at 16 x 16 with the default Bezier solve (``solve_winner``)
    on both sides."""
    _hold_k_slot_pass(16, newton=False)


def test_k_slot_eye_pass_newton_matches_jax():
    """K = 2 under the Newton kernel contract, at 24 x 24 where the one-slot
    pass holds (``test_eye_pass_slots_matches_jax``)."""
    _hold_k_slot_pass(24, newton=True)


def test_k_slot_eye_pass_newton_at_16_matches_jax():
    """K = 2 under the Newton kernel contract at 16 x 16, where pixel 51
    meets patch 3 at u = 0.999 (fault F2, ROADMAP section 3: the twin kept
    an iterate JAX's rounding rejects until it contracted multiply-adds as
    XLA's CPU code does)."""
    _hold_k_slot_pass(16, newton=True)


#: tests/test_eye_slots.py's mini scenes at 2 slots: a refl + refr sphere
#: whose split takes the second slot (1 ray, depth 3), and a buffer of 2
#: that overflows (4 rays, depth 1).
MINI = {"split": (("DIFF", "SPLIT"), 1, 16, 3), "overflow": (("DIFF", "DIFF"), 4, 2, 1)}


@pytest.mark.parametrize("name", sorted(MINI))
def test_k_slot_mini_scenes_match_jax(name):
    """Run free on the mini scenes (planes and a sphere, no chaos): count
    and dropped equal, the hit points in JAX's order, floats within the
    segment holding's tolerances (``testing``)."""
    import test_eye_slots as mini

    mats, n_rays, cap, depth = MINI[name]
    js = mini._mini_scene([getattr(mini, m) for m in mats])
    org, d = mini._rays(n_rays)
    hp_j, st_j = jeye.eye_pass(js, org, d, capacity=cap, max_depth=depth, slots=2)
    hp_p, st_p = eye.eye_pass(port_scene(js), torch.as_tensor(np.array(org)),
                              torch.as_tensor(np.array(d)), cap, depth, slots=2)
    for k in ("count", "dropped"):
        assert int(st_p[k]) == int(st_j[k]), k
    assert int(st_j["count"]) >= 1
    if name == "split":
        assert int(st_j["dropped"]) == 0       # the split found its slot
    else:
        assert int(st_j["dropped"]) >= 2
    for f in ("pixel", "valid"):
        np.testing.assert_array_equal(getattr(hp_p, f).numpy(), np.asarray(getattr(hp_j, f)))
    v = np.asarray(hp_j.valid)
    pos_j = np.asarray(hp_j.pos)[v]
    scale = np.linalg.norm(pos_j, axis=1, keepdims=True) + 1.0
    assert (np.abs(hp_p.pos.numpy()[v] - pos_j) <= POS_RTOL * scale).all()
    np.testing.assert_allclose(hp_p.n.numpy()[v], np.asarray(hp_j.n)[v], rtol=0,
                               atol=NORMAL_ATOL)
    wgt_j = np.asarray(hp_j.wgt)[v]
    np.testing.assert_allclose(hp_p.wgt.numpy()[v], wgt_j, rtol=0,
                               atol=COLOR_RTOL * np.abs(wgt_j).max())


def test_k_slots_refuse_a_compact_schedule():
    """As JAX asserts (eye.py:111-112): the staged wavefront has one slot."""
    with pytest.raises(ValueError, match="slots=1"):
        eye.eye_pass(None, torch.zeros(4, 3), torch.zeros(4, 3), 8, slots=2,
                     compact_schedule=((1, 0.5),))
