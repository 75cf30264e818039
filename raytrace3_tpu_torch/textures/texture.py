"""Texture atlas and bilinear wraparound sampling.

Port of ``raytrace3_tpu/textures/texture.py``.  The procedural generators
are host-side numpy, copied verbatim (the port may not import the JAX
package).  ``sample_atlas`` fetches the four bilinear taps with four
gathers; the JAX side packs them into one 12-float row because a TPU gather
costs per index, which a GPU gather does not.  ``load_image`` reads the
asset textures of ``RT3_ASSET_TEXTURES`` with PIL, imported only there.
"""

from __future__ import annotations

import numpy as np
import torch


def _taps(rows: int, cols: int, u: torch.Tensor, v: torch.Tensor):
    """Wrapped tap indices and weights of the reference rule
    (Element.h:61-72): row = fract(u) * rows, r1 = floor(row + 1e-10)."""
    row = (u - torch.floor(u)) * rows
    col = (v - torch.floor(v)) * cols
    r1 = torch.floor(row + 1e-10).to(torch.int32)
    c1 = torch.floor(col + 1e-10).to(torch.int32)
    det_r = (r1 + 1 - row)[..., None]
    det_c = (c1 + 1 - col)[..., None]
    r1 = torch.where(r1 >= 0, torch.where(r1 >= rows, 0, r1), rows - 1)
    c1 = torch.where(c1 >= 0, torch.where(c1 >= cols, 0, c1), cols - 1)
    return r1.long(), c1.long(), det_r, det_c


def _blend(q11, q12, q21, q22, det_r, det_c):
    return (q11 * det_r * det_c
            + q12 * det_r * (1.0 - det_c)
            + q21 * (1.0 - det_r) * det_c
            + q22 * (1.0 - det_r) * (1.0 - det_c))


def sample_bilinear_wrap(tex: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one (H, W, 3) texture with the reference's wrap
    rule: r2 = r1 + 1 of the UNwrapped r1, wrapping to 0 (Element.h:66-69)."""
    rows, cols = tex.shape[-3], tex.shape[-2]
    row = (u - torch.floor(u)) * rows
    col = (v - torch.floor(v)) * cols
    r1 = torch.floor(row + 1e-10).to(torch.int32)
    c1 = torch.floor(col + 1e-10).to(torch.int32)
    r2, c2 = r1 + 1, c1 + 1
    det_r = (r2 - row)[..., None]
    det_c = (c2 - col)[..., None]
    r1 = torch.where(r1 >= 0, torch.where(r1 >= rows, 0, r1), rows - 1).long()
    c1 = torch.where(c1 >= 0, torch.where(c1 >= cols, 0, c1), cols - 1).long()
    r2 = torch.where(r2 < rows, r2, 0).long()
    c2 = torch.where(c2 < cols, c2, 0).long()
    return _blend(tex[r1, c1], tex[r1, c2], tex[r2, c1], tex[r2, c2],
                  det_r, det_c)


def sample_atlas(atlas: torch.Tensor, tex_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Sample the (T, H, W, 3) atlas at per-lane texture ids.

    The taps of the JAX side's packed atlas: the neighbours of the wrapped
    (r1, c1) are (r1 + 1) mod H and (c1 + 1) mod W.  Negative ids clip to 0;
    callers select the flat colour for those lanes.
    """
    t_, rows, cols, _ = atlas.shape
    tid = torch.clamp(tex_id, 0, t_ - 1).long()
    r1, c1, det_r, det_c = _taps(rows, cols, u, v)
    r2, c2 = (r1 + 1) % rows, (c1 + 1) % cols
    return _blend(atlas[tid, r1, c1], atlas[tid, r1, c2], atlas[tid, r2, c1],
                  atlas[tid, r2, c2], det_r, det_c)


# ---------------------------------------------------------------------------
# Procedural stand-ins for the reference assets (deterministic, file-free),
# copied from the JAX package.
# ---------------------------------------------------------------------------

def checker(res: int = 256, tiles: int = 8, c0=(0.9, 0.9, 0.9), c1=(0.1, 0.1, 0.1)) -> np.ndarray:
    y, x = np.mgrid[0:res, 0:res]
    m = (((y * tiles // res) + (x * tiles // res)) % 2).astype(np.float32)
    return (np.outer(1 - m, c0) + np.outer(m, c1)).reshape(res, res, 3).astype(np.float32)


def bricks(res: int = 256) -> np.ndarray:
    """Wall-like brick pattern (stand-in for wall.jpg)."""
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    row = np.floor(y * 8)
    xs = x + 0.5 * (row % 2)
    mortar = ((np.abs((y * 8) % 1.0) < 0.08) | (np.abs((xs * 4) % 1.0) < 0.05))
    base = np.stack([0.62 + 0.08 * np.sin(37 * x + 11 * y), 0.32 * np.ones_like(x), 0.26 * np.ones_like(x)], -1)
    out = np.where(mortar[..., None], np.array([0.75, 0.73, 0.7]), base)
    return out.astype(np.float32)


def planet(res: int = 256, seed: int = 7) -> np.ndarray:
    """Banded-noise planet (stand-in for planet.jpg)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    val = np.zeros((res, res), np.float32)
    for octave in range(1, 5):
        f = 2.0**octave
        ph = rng.uniform(0, 2 * np.pi, 2)
        val += np.sin(2 * np.pi * f * y + ph[0]) * np.cos(2 * np.pi * f * x + ph[1]) / f
    val = (val - val.min()) / (np.ptp(val) + 1e-9)
    a = np.array([0.85, 0.65, 0.4], np.float32)
    b = np.array([0.3, 0.45, 0.6], np.float32)
    return (val[..., None] * a + (1 - val[..., None]) * b).astype(np.float32)


def marble(res: int = 256) -> np.ndarray:
    """Marble-ish veins (stand-in for timg.jpg floor)."""
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    v = 0.5 + 0.5 * np.sin(14 * x + 6 * np.sin(9 * y + 3 * np.sin(5 * x)))
    base = 0.55 + 0.4 * v
    return np.stack([base, base * 0.98, base * 0.95], -1).astype(np.float32)


def flat(res: int = 256, color=(0.2, 0.4, 0.9)) -> np.ndarray:
    return np.broadcast_to(np.asarray(color, np.float32), (res, res, 3)).copy()


def load_image(path: str, res: int = 256) -> np.ndarray:
    """Load an image file into a (res, res, 3) float32 RGB array in [0, 1]:
    PIL's bilinear resize (which widens its filter when it shrinks), as the
    JAX package's ``load_image`` does, so both give the same numbers."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading the asset texture {path} (RT3_ASSET_TEXTURES) needs "
                          "PIL, which is not installed; unset RT3_ASSET_TEXTURES to use "
                          "the procedural textures") from e

    img = Image.open(path).convert("RGB").resize((res, res), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def build_atlas(textures: list[np.ndarray], device="cpu") -> torch.Tensor:
    """Stack equal-resolution textures into the (T, H, W, 3) atlas."""
    if not textures:
        return torch.ones((1, 4, 4, 3), dtype=torch.float32, device=device)
    return torch.as_tensor(np.stack(textures, 0).astype(np.float32), device=device)
