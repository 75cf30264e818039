"""Work counts of the kernel contracts, one module each, and the card's
peaks (``peaks.json``).  A count depends only on a call's inputs, never on
how a kernel tiles, chunks, bands or culls them."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """(the least time the card could take, the bound that sets it)."""
    tc = flops / PEAKS["fp32_flop_per_s"]
    tb = nbytes / PEAKS["hbm_bytes_per_s"]
    return (tc, "compute") if tc >= tb else (tb, "memory")
