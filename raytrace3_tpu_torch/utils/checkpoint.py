"""Checkpoint and resume of the progressive render.

Port of ``raytrace3_tpu/utils/checkpoint.py``'s ``save`` / ``load``, in the
same ``.npz`` format (keys ``accum``, ``passes_done``, ``seed``, ``extra``,
written to a temporary file and renamed into place), so that either package
resumes from the other's checkpoint.  Pass i of a render is a pure function
of (seed, i), so resuming at the saved pass repeats the uninterrupted run.

The train state (:func:`save_tree` / :func:`load_tree`) is a nested dict of
tensors, stored as JAX's ``.npz``: one array a leaf under JAX's key-path
string (``['params']['diff']``) and the step under ``__step__``, so a
params file loads in either package.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


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


def flatten_tree(tree, prefix: str = "") -> dict:
    """{key path: leaf} of a nested dict / list / tuple of tensors, the
    paths as ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        items = ((f"[{k!r}]", v) for k, v in sorted(tree.items()))
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for key, v in items:
        flat.update(flatten_tree(v, prefix + key))
    return flat


def _unflatten(template, leaves: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return leaves[prefix]


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype


def save_tree(path: str, tree, step: int = 0) -> None:
    """Write a nested dict (lists and tuples too) of tensors and ``step``
    to ``path``, through a temporary file renamed into place."""
    flat = {k: v.detach().cpu().numpy() for k, v in flatten_tree(tree).items()}
    tmp = path + ".tmp.npz"
    np.savez(tmp, __step__=np.int64(step), **flat)
    os.replace(tmp, path)


def load_tree(path: str, template):
    """(tree, step) saved by :func:`save_tree` (or by the JAX package's),
    shaped as ``template``, whose tensors give each leaf's shape, dtype and
    device; every leaf must be in the file.  None if there is no file.
    A leaf of another shape or dtype is refused (a silent cast would
    corrupt precision)."""
    if not os.path.exists(path):
        return None
    leaves = {}
    with np.load(path, allow_pickle=False) as z:
        for key, tmpl in flatten_tree(template).items():
            arr = z[key]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != template "
                                 f"{tuple(tmpl.shape)}")
            want = _numpy_dtype(tmpl)
            if arr.dtype != want:
                raise ValueError(f"checkpoint leaf {key} dtype {arr.dtype} != template "
                                 f"{want} (silent casts corrupt precision; rebuild the "
                                 "template with matching dtypes)")
            leaves[key] = torch.from_numpy(arr).to(tmpl.device)
        step = int(z["__step__"])
    return _unflatten(template, leaves), step
