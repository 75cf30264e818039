"""Masked index compaction.

Port of ``raytrace3_tpu/ops/compact.py``: one stable sort of ``~mask`` puts
the True lanes first in their original order, with no host sync (unlike
``torch.nonzero``, whose output size depends on the data).
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, cap: int,
                    fill: int | None = None) -> torch.Tensor:
    """Indices of the True lanes of ``mask`` in ascending order, the first
    ``cap`` of them, padded with ``fill`` (default ``mask.shape[0]``).

    The contract of ``jnp.nonzero(mask, size=cap, fill_value=fill)[0]``;
    True lanes beyond ``cap`` are left out (callers count them).  Returns
    int64, ready for indexing.
    """
    n = mask.shape[0]
    if fill is None:
        fill = n
    if cap > n:
        raise ValueError(f"cap {cap} exceeds the mask length {n}")
    _, idx = torch.sort((~mask).to(torch.int32), stable=True)
    idx = idx[:cap]
    return torch.where(mask[idx], idx, fill)
