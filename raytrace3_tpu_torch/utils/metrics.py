"""Per-pass metrics of a render and their JSONL sink.

Port of ``raytrace3_tpu/utils/metrics.py``: the same record fields
(``pass``, ``pass_seconds``, ``photons_per_s``, ``mrays_per_s`` and the
caller's extras) and the same ``summary()``.  Times are host seconds around
a pass that ends in a device synchronisation (``render.driver.render``).
"""

from __future__ import annotations

import json
import logging
import time

logger = logging.getLogger("raytrace3_tpu_torch")


class PassMeter:
    """Throughput over the passes of a render."""

    def __init__(self, photons_per_pass: float, rays_per_pass: float,
                 jsonl_path: str | None = None):
        self.photons_per_pass = photons_per_pass
        self.rays_per_pass = rays_per_pass
        self.jsonl_path = jsonl_path
        self.passes = 0
        self.total_time = 0.0

    def start_pass(self):
        self._pass_t0 = time.perf_counter()

    def end_pass(self, extra: dict | None = None,
                 photons: float | None = None) -> dict:
        """``photons`` replaces the static per-pass count (the regen walk
        emits a data-dependent number of photons)."""
        dt = time.perf_counter() - self._pass_t0
        self.passes += 1
        self.total_time += dt
        if photons is not None:
            self.photons_per_pass = photons          # the last pass's count
        rec = {
            "pass": self.passes,
            "pass_seconds": dt,
            "photons_per_s": self.photons_per_pass / dt,
            "mrays_per_s": self.rays_per_pass / dt / 1e6,
            **(extra or {}),
        }
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        logger.info("pass %d: %.2fs  %.3g photons/s  %.2f Mrays/s",
                    self.passes, dt, rec["photons_per_s"], rec["mrays_per_s"])
        return rec

    def summary(self) -> dict:
        t = max(self.total_time, 1e-9)
        return {
            "passes": self.passes,
            "total_seconds": t,
            "photons_per_s": self.passes * self.photons_per_pass / t,
            "mrays_per_s": self.passes * self.rays_per_pass / t / 1e6,
        }
