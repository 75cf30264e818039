"""The device an entry point runs on: the card, unless the caller asks for
the CPU.

The port's entry points (``render.driver.build_scene``, ``scenes.full``,
``scenes.get_scene``, ``scenes.reference_camera``, ``diff.train``'s
``make_render_fn`` and ``make_train_step`` through their scene) default to
``DEFAULT_DEVICE``.  Without a card they raise; they never carry on on the
CPU unasked.  Tests and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import collections
import linecache
import os
import statistics
import subprocess
import time
import warnings

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


def call_times(fn, reps: int, device) -> tuple[float | None, float]:
    """(device ms, wall ms) of one call of ``fn``, each the median over
    ``reps`` calls after a warm one.  Device ms: CUDA events recorded around
    the call (on the CPU, None); wall ms: the host's clock from the call to
    its work finished (the device synchronised)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    dev, wall = [], []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        fn()
        if cuda:
            end.record()
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            dev.append(start.elapsed_time(end))
    return (statistics.median(dev) if cuda else None), statistics.median(wall)


def device_events(fn) -> int:
    """The device events (kernels, copies, fills) of ``fn()`` on the card,
    under ``torch.profiler``: in a host-bound pass, what the host issues."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def synchronizing_calls(fn, root: str | None = None):
    """(``fn()``, the calls in it that made the host wait for the card)
    under ``torch.cuda.set_sync_debug_mode("warn")``: a dict from each
    Python line that made one (``path:line``, relative to ``root``) to
    {"count", "code"}.  Without a card the calls are None."""
    if not torch.cuda.is_available():
        return fn(), None
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(before)
    # Only the per-call warnings: torch also warns, once a process, that
    # the mode is a prototype, attributed to the line that set it.
    lines = collections.Counter(
        (w.filename, w.lineno) for w in caught
        if str(w.message).startswith("called a synchronizing CUDA operation"))
    calls = {}
    for (path, line), n in lines.most_common():
        name = os.path.relpath(path, root) if root else path
        calls[f"{name}:{line}"] = {"count": n,
                                   "code": linecache.getline(path, line).strip()}
    return out, calls
