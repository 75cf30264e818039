"""The single-card forward check: ``(fn, example_args)`` of one SPPM pass on
the flagship scene.

Port of ``__graft_entry__.entry``: the ``full`` scene (the Cornell box, the
mirror and glass spheres, the textured sphere, the 32-patch Bezier teapot)
at 64^2, 2 rounds x 4096 photons, depth 6, atlas 64, Bezier compaction
0.25, 3 restarts of the default solver, from the reference camera.  Like
JAX's, it passes no deposit or Newton function to ``make_pass_fn``: the
pass runs the brute-force deposit and ``solve_winner``, on the card unless
the caller asks for the CPU.

    fn, args = entry()          # entry(device="cpu") on the CPU
    image = fn(*args)           # (64, 64, 3)
"""

from __future__ import annotations

import torch

from .core.device import DEFAULT_DEVICE
from .render.driver import CAMERA_LOOK, CAMERA_POS, build_scene, make_pass_fn
from .utils.config import RenderConfig

#: ``__graft_entry__.py:17-21``'s configuration.
CONFIG = RenderConfig(scene="full", width=64, height=64, passes=1, rounds=2,
                      photons_per_round=4096, max_depth=6, atlas_res=64,
                      bezier_compact_frac=0.25, newton_restarts=3)


def entry_pass(device=DEFAULT_DEVICE):
    """The pass ``rng -> (image (64, 64, 3), stats)`` that :func:`entry`'s
    ``fn`` runs."""
    scene = build_scene(CONFIG, device)
    return make_pass_fn(scene, CONFIG, CAMERA_POS, CAMERA_LOOK)


def entry(device=DEFAULT_DEVICE):
    """``(fn, example_args)``: ``fn(rng)`` renders one pass and returns its
    image (64, 64, 3); ``example_args`` is a ``torch.Generator`` seeded 0 on
    the pass's device."""
    pass_fn = entry_pass(device)

    def fn(rng):
        img, _ = pass_fn(rng)
        return img

    dev = torch.device(device)
    return fn, (torch.Generator(device=dev).manual_seed(0),)
