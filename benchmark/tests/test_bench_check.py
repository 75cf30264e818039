"""The check that decides ``correct``: the program held to the plain
reference at a tiny size on the CPU passes; the control (the reference in
TF32 in the program's place) and each fault a render cell can have, planted
under the timed path, fail it."""

import functools
import math

import pytest
import torch

from benchmark.drivers import render

from .conftest import SEED


def failed(nums: dict, limits: dict) -> list:
    return [k for k, v in nums.items() if not v <= limits[k]]


def test_the_program_holds(cell):
    c, limits = cell
    img, host, _, _ = c.one_pass(SEED, 0, c.zeros())
    h = c.hold(SEED, 0, img)
    assert h.faults == []
    assert failed(render.numbers([h]), limits) == []
    assert host["dropped"] == 0 and host["deposits_dropped"] == 0
    assert h.lanes[1] > 1000 and h.slots[1] > 100


def test_the_control_fails(cell):
    c, limits = cell
    h = c.hold(SEED, 0, None, subject="control")
    assert {"walk_mismatch_share", "update_rel_err", "estimate_rel_err"} <= set(
        failed(render.numbers([h]), limits))


def _state_unchanged(monkeypatch):
    from raytrace3_tpu_torch.render import sppm

    monkeypatch.setattr(sppm, "ppm_update_arrays",
                        lambda r2, tao, nphot, dn, dt, *a, **k: (r2, tao, nphot))


def _half_the_deposits(monkeypatch):
    from raytrace3_tpu_torch.ops.deposit_kernel import DepositTile

    real = DepositTile.packed_call

    def half(self, r2_pad, dep, prep):
        keep = torch.arange(dep.valid.shape[0]) % 2 == 0
        return real(self, r2_pad, dep.replace(valid=dep.valid & keep), prep)
    monkeypatch.setattr(DepositTile, "packed_call", half)


def _image_altered(monkeypatch):
    from raytrace3_tpu_torch.render import sppm

    real = sppm.estimate_image
    monkeypatch.setattr(sppm, "estimate_image", lambda *a: real(*a) * 1.01)


def _walk_altered(monkeypatch):
    from raytrace3_tpu_torch.render import photon

    real = photon.regen_segment

    @functools.wraps(real)
    def bent(*a, **k):
        (o, d, *rest), rec = real(*a, **k)
        return (o, d * (1.0 + 1e-2), *rest), rec
    monkeypatch.setattr(photon, "regen_segment", bent)


def _walk_unchanged(monkeypatch):
    from raytrace3_tpu_torch.render import photon

    real = photon.regen_segment

    @functools.wraps(real)
    def stuck(scene, fetch_mat, draws, light_pos, light_color, carry, *a, **k):
        _, rec = real(scene, fetch_mat, draws, light_pos, light_color, carry, *a, **k)
        return carry, rec
    monkeypatch.setattr(photon, "regen_segment", stuck)


@pytest.mark.parametrize("plant,catches", [
    (_state_unchanged, "update_rel_err"),
    (_half_the_deposits, "deposit_mismatch_share"),
    (_image_altered, "estimate_rel_err"),
    (_walk_altered, "walk_mismatch_share"),
    (_walk_unchanged, "walk_mismatch_share"),
], ids=["update-state-unchanged", "half-the-deposits", "image-altered", "walk-altered",
        "walk-state-unchanged"])
def test_a_planted_fault_fails_the_check(cell, monkeypatch, plant, catches):
    c, limits = cell
    img, _, _, _ = c.one_pass(SEED, 1, c.zeros())       # the window's pass, sound
    plant(monkeypatch)
    h = c.hold(SEED, 1, img)
    assert catches in failed(render.numbers([h]), limits)


def test_the_replay_must_equal_the_window(cell):
    c, limits = cell
    img, _, _, _ = c.one_pass(SEED, 2, c.zeros())
    h = c.hold(SEED, 2, img * (1.0 + 2.0 ** -20))
    assert "image_replay_diff" in failed(render.numbers([h]), limits)
    assert math.isfinite(h.image_diff) and h.image_diff > 0


def test_a_pass_that_drops_eye_rays_is_held_and_counted():
    """An eye schedule too narrow for the pass drops rays; the check holds
    the rays kept and the count of those dropped (the run counts the pass
    in ``failed``)."""
    from .conftest import tiny_cell

    # 32 x 32 rays; about a fifth survive the first segment, which the
    # schedule gathers into 128 lanes.
    c, limits = tiny_cell(width=32, height=32,
                          eye_compact_schedule=[[1, 0.1], [4, 0.1], [6, 0.1]])
    img, host, _, _ = c.one_pass(SEED, 0, c.zeros())
    assert host["dropped"] > 0
    h = c.hold(SEED, 0, img)
    assert h.faults == [] and failed(render.numbers([h]), limits) == []
