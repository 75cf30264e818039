"""Image output: the reference's tone map and a flipped 8-bit PNG.

Port of ``raytrace3_tpu/utils/image.py``.  The reference writes the
tone-mapped running average with a vertical flip (row h-1-y,
raytracer/Raytracer.h:460-474); so does :func:`save_png`.  The PNG encoder
is the standard library's (``zlib``, ``struct``): 8-bit RGB, one filter
byte of 0 per row, CRCs by ``zlib.crc32``.  It needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img: np.ndarray) -> np.ndarray:
    """toInt (Raytracer.h:24-26) on an (H, W, 3) float radiance image."""
    v = np.power(1.0 - np.exp(-np.maximum(np.asarray(img, np.float64), 0.0)),
                 1.0 / 2.2)
    return np.clip(np.floor(v * 255.0 + 0.5), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as the bytes of an 8-bit RGB PNG, rows top
    to bottom as given."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got shape {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray, tonemapped: bool = False) -> None:
    """Write an (H, W, 3) image to PNG with the reference's vertical flip."""
    arr = np.asarray(img)
    if not tonemapped:
        arr = to_uint8(arr)
    with open(path, "wb") as f:
        f.write(encode_png(arr[::-1]))


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio between two radiance images (dB)."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))
