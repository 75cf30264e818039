"""``raytrace3_tpu_torch.entry.entry()`` against ``__graft_entry__.entry``.

* Its ``RenderConfig`` equals the one JAX's ``entry()`` builds, field by
  field, and so do the camera pose and the scene: JAX's config is captured
  by replacing ``raytrace3_tpu.render.driver.make_pass_fn``, so no JAX
  pass runs.
* ``fn(*example_args)`` is ``make_pass_fn``'s pass at the entry's config
  on the same generator, bit for bit, its image finite and positive with
  both drop counters 0.  On the CPU the full config's pass takes ~40 s at
  two threads (the brute-force deposit and ``solve_winner``, as JAX's
  entry asks), so this is held at the config cut to 16^2 and 2 x 256
  photons; ``chip_smoke.py`` phase 23 holds the full one on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu_torch import entry as port_entry
from raytrace3_tpu_torch.render.driver import CAMERA_LOOK, CAMERA_POS, make_pass_fn


def test_entry_config_and_camera_equal_jax(monkeypatch):
    import __graft_entry__
    import raytrace3_tpu.render.driver as jdriver

    seen = {}

    def capture(scene, cfg, base_pos, base_look, *args, **kwargs):
        seen.update(scene=scene, cfg=cfg, pos=np.asarray(base_pos), look=np.asarray(base_look))
        return lambda key: (None, None)

    monkeypatch.setattr(jdriver, "make_pass_fn", capture)
    fn, (key,) = __graft_entry__.entry()
    want = dataclasses.asdict(seen["cfg"])
    got = dataclasses.asdict(port_entry.CONFIG)
    assert got == want
    np.testing.assert_array_equal(CAMERA_POS, seen["pos"])
    np.testing.assert_array_equal(CAMERA_LOOK, seen["look"])
    scene = port_entry.build_scene(port_entry.CONFIG, "cpu")
    assert scene.bezier.ctrl.shape[0] == seen["scene"].bezier.ctrl.shape[0] == 32
    np.testing.assert_array_equal(scene.atlas.numpy(), np.asarray(seen["scene"].atlas))


def test_entry_is_the_pass_and_drops_nothing(monkeypatch):
    monkeypatch.setattr(port_entry, "CONFIG", port_entry.CONFIG.replace(
        width=16, height=16, photons_per_round=256))
    fn, args = port_entry.entry(device="cpu")
    assert len(args) == 1 and isinstance(args[0], torch.Generator)
    assert args[0].initial_seed() == 0 and args[0].device.type == "cpu"
    img = fn(*args)
    scene = port_entry.build_scene(port_entry.CONFIG, "cpu")
    want, stats = make_pass_fn(scene, port_entry.CONFIG, CAMERA_POS, CAMERA_LOOK)(
        torch.Generator().manual_seed(0))
    assert img.shape == (16, 16, 3)
    assert torch.equal(img, want)
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0
    assert int(stats["dropped"]) == 0 and int(stats["deposits_dropped"]) == 0


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_entry.entry()
