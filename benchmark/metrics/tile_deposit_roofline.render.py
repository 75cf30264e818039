"""The tile deposit kernel's share of its roofline: the least time its
calls' inputs need (``benchmark/work/tile_deposit.py``, against the card's
float32 and HBM peaks) over its summed device time in the traced passes,
in %."""

from benchmark.harness.profile import kernel_seconds
from benchmark.work import least_seconds, tile_deposit

KERNEL = "deposit_tile_kernel"


def read(layer: dict):
    if "kernel_s" not in layer or not layer.get("work", {}).get("deposit"):
        return None
    spent = kernel_seconds(layer, KERNEL)
    if spent <= 0:
        return None
    least, _ = least_seconds(*tile_deposit.work(layer["work"]["deposit"]))
    return 100.0 * least / spent
