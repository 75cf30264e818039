#!/usr/bin/env python3
"""The sharded phases of ``chip_smoke.py`` alone, on every card of the machine.

Run from the repository root on a machine with one or more NVIDIA GPUs:

    python3 scripts/torch_sharded_cards.py

It builds the six kernels (phase 1), then runs phases 16-18 with the world
size the cards give: phase 16's ``sharded10m`` render over NCCL, one rank a
card (1 x N); phase 17's two ranks on one card over gloo, and with two cards
or more the same runs over NCCL, one rank a card (the 1 x 2 pass, the ring,
the sharded train256 step); phase 18's dry run on 4 ranks, over NCCL with
four cards.  Every rank holds its kernels to their plain twins on the
inputs its run gave them, as in ``chip_smoke.py``.  It ends with the launch
counts by path, each summed over the ranks; a phase that fails ends the
run with a non-zero exit.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("this script needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import chip_smoke as cs
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off before any work)
    from raytrace3_tpu_torch.core.device import card_line

    card = card_line()
    print(f"{card}; cards: {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    cs.phase_build(card)
    paths = {"sharded": cs.phase_sharded(card), "sharded_gloo": cs.phase_sharded_gloo(card),
             "dryrun": cs.phase_dryrun(card)}
    print(f"launches by path {paths}")
    print(f"phases 1 and 16-18 done in {time.perf_counter() - t0:.1f} s ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
