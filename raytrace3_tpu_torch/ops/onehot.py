"""Small-table lookups.

Port of ``raytrace3_tpu/ops/onehot.py``.  The one-hot contractions there
exist because TPU gathers cost per index; on the GPU a gather is cheap, so
``take_rows`` and ``pick_columns`` are plain indexing.  They keep their
names so that call sites read as on the JAX side.
"""

from __future__ import annotations

import torch


def onehot_f32(idx: torch.Tensor, k: int) -> torch.Tensor:
    """(R,) int -> (R, K) float32 one-hot; indices outside [0, K) select
    nothing."""
    return (idx[:, None] == torch.arange(k, device=idx.device)).to(torch.float32)


def take_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tbl[idx]``: (K, ...) x (R,) -> (R, ...); ``idx`` lies in [0, K)."""
    return tbl[idx.long()]


def pick_columns(arr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``arr[arange(R), col]``: (R, K) x (R,) -> (R,)."""
    return arr.gather(1, col.long()[:, None])[:, 0]
