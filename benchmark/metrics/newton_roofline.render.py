"""The Newton kernel's share of its roofline: the least time its calls'
inputs need (``benchmark/work/newton.py``, against the card's float32 and
HBM peaks) over its summed device time in the traced passes, in %."""

from benchmark.harness.profile import kernel_seconds
from benchmark.work import least_seconds, newton

KERNEL = "newton_kernel"


def read(layer: dict):
    if "kernel_s" not in layer or not layer.get("work", {}).get("newton"):
        return None
    spent = kernel_seconds(layer, KERNEL)
    if spent <= 0:
        return None
    cfg = layer["config"]
    least, _ = least_seconds(*newton.work(layer["work"]["newton"], cfg["newton_restarts"],
                                          cfg["newton_iters"]))
    return 100.0 * least / spent
