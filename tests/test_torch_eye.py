"""Eye pass: the port's staged-width wavefront (``_eye_pass_compact``) and
one-slot wavefront (``eye_pass`` with no schedule) vs the JAX package's on
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
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments

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


def test_k_slot_path_is_not_ported():
    with pytest.raises(NotImplementedError):
        eye.eye_pass(None, torch.zeros(4, 3), torch.zeros(4, 3), 8, slots=2)
