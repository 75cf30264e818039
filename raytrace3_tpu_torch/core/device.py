"""The device an entry point runs on: the card, unless the caller asks for
the CPU.

The port's entry points (``render.driver.build_scene``, ``scenes.full``,
``scenes.get_scene``, ``scenes.reference_camera``, ``diff.train``'s
``make_render_fn`` and ``make_train_step`` through their scene) default to
``DEFAULT_DEVICE``.  Without a card they raise; they never carry on on the
CPU unasked.  Tests and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and there is
    no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs an NVIDIA GPU, and "
            "torch.cuda.is_available() is false: pass device='cpu' to run "
            "on the CPU")
    return dev
