"""The segment-by-segment comparison of ``raytrace3_tpu_torch.testing``,
on the port alone: a run held to its own recording agrees bit for bit, and
the lane checks refuse what they must refuse (a changed decision, a point
or colour beyond tolerance outside its class, a run longer than its
reference, a one-sided self-hit beyond ``FLIP_T``) and accept what the
far-field class and the self-hit flip allow.
"""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu_torch import testing
from raytrace3_tpu_torch.core.sampling import (GeneratorDraws, RecordingDraws,
                                               ReplayDraws)
from raytrace3_tpu_torch.core.vecmath import M_EPS
from raytrace3_tpu_torch.ops.deposit_kernel import (make_tile_deposit,
                                                    world_bounds_from_scene)
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import driver, photon
from raytrace3_tpu_torch.scenes import full
from raytrace3_tpu_torch.utils.config import RenderConfig

BASE = np.array([50.0, 35.0, 230.0])
LOOK = BASE + np.array([0.0, 0.042612, -1.0])
SMALL = dict(scene="full", width=16, height=16, passes=1, rounds=1,
             photons_per_round=256, max_depth=13, atlas_res=16,
             bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
             newton_iters=10, hitpoint_factor=1.3, photon_regen=True,
             eye_compact_schedule=((1, 0.25), (4, 0.04), (6, 0.02)))


def _pass_fn():
    cfg = RenderConfig(**SMALL)
    scene = driver.build_scene(cfg, device="cpu")
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    return driver.make_pass_fn(
        scene, cfg, BASE, LOOK, newton_fn=make_newton(10, 8),
        deposit_fn=make_tile_deposit(**{k: b[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")}))


def test_pinned_run_matches_its_own_recording():
    fn = _pass_fn()
    draws = RecordingDraws(GeneratorDraws(torch.Generator().manual_seed(5)))
    with testing.recording_segments() as steps:
        img_a, st_a = fn(draws)
    assert len(steps["eye"]) == 14 and len(steps["photon"]) == 14
    with testing.pinned_segments(steps["eye"], steps["photon"]) as report:
        img_b, st_b = fn(ReplayDraws(draws.arrays))
    assert report.segments == {"eye": 14, "photon": 14}
    assert report.lanes["self-hit flip"] == 0
    assert all(v == 0.0 for v in report.max_err.values()), report.max_err
    np.testing.assert_array_equal(img_b.numpy(), img_a.numpy())
    for k in st_a:
        assert float(st_b[k]) == float(st_a[k]), k


@pytest.fixture(scope="module")
def walk_steps():
    scene = full(atlas_res=16, device="cpu").replace(bezier_compact_frac=0.05)
    with testing.recording_segments() as steps:
        photon.photon_trace_regen(scene, torch.Generator().manual_seed(2),
                                  scene.light_pos, scene.light_color, 256, None,
                                  13, newton_fn=make_newton())
    return scene, steps["photon"]


def _pick(steps, light_pos, want_far):
    """A segment and a lane that stays alive with a hit in the room (or
    outside it), away from its origin."""
    for k, (carry, (out, rec)) in enumerate(steps):
        alive_in, alive_out = carry[3], out[3]
        far = rec[0].abs().amax(-1) > testing.FAR_FIELD
        t = (rec[0] - carry[0]).norm(dim=-1)
        ok = alive_in & alive_out & (t > 1.0) & (far if want_far else ~far)
        if bool(ok.any()):
            return k, int(torch.nonzero(ok)[0])
    raise AssertionError("no such lane")


def _perturbed(carry, out, rec, field, lane, factor):
    out, rec = [x.clone() for x in out], [x.clone() for x in rec]
    if field == "valid":
        rec[3][lane] = ~rec[3][lane]
    elif field == "self-hit":       # a hit ``factor`` from the origin instead
        rec[0][lane] = carry[0][lane] + factor * carry[1][lane]
        rec[3][lane] = ~rec[3][lane]
    elif field == "position":
        rec[0][lane] *= factor
    elif field == "flux":
        out[2][lane] *= factor
    return tuple(out), tuple(rec)


@pytest.mark.parametrize("field, far, factor, refused", [
    ("valid", False, None, True),
    ("position", False, 1 + 1e-3, True),
    ("flux", False, 1 + 1e-2, True),
    ("flux", True, 1 + 1e-2, False),
    ("flux", True, 1.2, True),
    ("self-hit", False, 1.2 * M_EPS, False),     # straddles M_EPS: a counted flip
    ("self-hit", False, 0.05, True),             # beyond FLIP_T: a mismatch
])
def test_photon_lane_checks(walk_steps, field, far, factor, refused):
    scene, steps = walk_steps
    k, lane = _pick(steps, scene.light_pos, far)
    carry, (out, rec) = steps[k]
    got = _perturbed(carry, out, rec, field, lane, factor)
    report = testing.Report()
    if refused:
        with pytest.raises(testing.SegmentMismatch):
            testing.check_photon_segment(carry, scene.light_pos, got, (out, rec), report)
    else:
        testing.check_photon_segment(carry, scene.light_pos, got, (out, rec), report)
        if field == "self-hit":
            assert report.lanes["self-hit flip"] == 1
        else:
            assert report.max_err["photon flux (far field)"] > 5e-3


def test_a_run_longer_than_its_reference_is_refused(walk_steps):
    scene, steps = walk_steps
    with pytest.raises(testing.SegmentMismatch):
        with testing.pinned_segments(photon_steps=steps[:5]):
            photon.photon_trace_regen(scene, torch.Generator().manual_seed(2),
                                      scene.light_pos, scene.light_color, 256,
                                      None, 13, newton_fn=make_newton())
    assert photon.regen_segment.__name__ == "regen_segment"     # restored
