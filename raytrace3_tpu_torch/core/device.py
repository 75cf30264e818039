"""The device an entry point runs on: the card, unless the caller asks for
the CPU.

The port's entry points (``render.driver.build_scene``, ``scenes.full``,
``scenes.get_scene``, ``scenes.reference_camera``, ``diff.train``'s
``make_render_fn`` and ``make_train_step`` through their scene) default to
``DEFAULT_DEVICE``.  Without a card they raise; they never carry on on the
CPU unasked.  Tests and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import subprocess

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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card's): the
    context every number measured on it is written down with."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def record_fields(device) -> dict:
    """The keys a record written by a port script carries about where it
    ran: ``device`` (``"cuda"`` or ``"cpu"``), and on the card its
    ``card`` name and ``power_limit`` (``card_line``'s two fields; None on
    the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": dev.type, "card": None, "power_limit": None}
    name, limit = (s.strip() for s in card_line().rsplit(",", 1))
    return {"device": dev.type, "card": name, "power_limit": limit}
