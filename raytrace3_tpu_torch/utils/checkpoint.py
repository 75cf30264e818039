"""Checkpoint and resume of the progressive render.

Port of ``raytrace3_tpu/utils/checkpoint.py``'s ``save`` / ``load``, in the
same ``.npz`` format (keys ``accum``, ``passes_done``, ``seed``, ``extra``,
written to a temporary file and renamed into place), so that either package
resumes from the other's checkpoint.  Pass i of a render is a pure function
of (seed, i), so resuming at the saved pass repeats the uninterrupted run.
The train-state checkpoint (``save_tree`` / ``load_tree``) waits for a later
slice.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save(path: str, accum: np.ndarray, passes_done: int, seed: int,
         extra: dict | None = None) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, accum=np.asarray(accum), passes_done=np.int64(passes_done),
             seed=np.int64(seed), extra=json.dumps(extra or {}))
    os.replace(tmp, path)


def load(path: str):
    """(accum, passes_done, seed, extra), or None if there is no file."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return (z["accum"], int(z["passes_done"]), int(z["seed"]),
                json.loads(str(z["extra"])))
