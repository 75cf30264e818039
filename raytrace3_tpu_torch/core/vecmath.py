"""Vector math on batched ``(..., 3)`` tensors.

Port of ``raytrace3_tpu/core/vecmath.py``: the same branchless formulas, in
the same operation order, with ``torch.where`` for ``jnp.where``.
"""

from __future__ import annotations

import torch

#: Reference epsilon (raytracer/Vec3.h:6).
M_EPS = 1e-4
#: Sentinel distance; squares of sentinel-scaled positions stay finite in fp32.
MAX_DIST = 1e9


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` over the trailing axis of 3, summed x + y + z from the left.

    Written out, not ``(a * b).sum(-1)``: the CPU's sum adds in this order,
    a CUDA reduction kernel in another (30% of random inputs round
    differently on an H100), and the sphere self-hit test turns on the last
    ulps of ``L . L``, so a pass on the card would trap other eye rays in the
    mirror sphere than the same pass on the CPU (ROADMAP.md, F3).  The
    Newton kernel (csrc/newton.cu) sums in this order too.
    """
    x, y, z = (a * b).unbind(-1)
    return x + y + z


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def norm2(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(norm2(v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit vector; near-zero vectors pass through (Vec3.h:48-55)."""
    n2 = norm2(v)[..., None]
    small = n2 < M_EPS * M_EPS
    m = torch.sqrt(torch.where(small, 1.0, n2))
    return torch.where(small, v, v / m)


def dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return dot(d, d)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``d - 2 (d.n) n`` (Vec3.h:80-84)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """Snell refraction with the total-internal-reflection fallback to the
    mirror direction (Vec3.h:124-134); ``eta = n_from / n_to``."""
    eta = torch.as_tensor(eta, dtype=d.dtype, device=d.device).expand(d.shape[:-1])
    cos_i = -dot(n, d)
    cos_r2 = 1.0 - (1.0 - cos_i * cos_i) * eta * eta
    ok = cos_r2 > M_EPS
    cos_r = torch.sqrt(torch.where(ok, cos_r2, 1.0))
    refr = d * eta[..., None] + n * (eta * cos_i - cos_r)[..., None]
    return torch.where(ok[..., None], refr, reflect(d, n))


def anormal(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to ``v`` (Vec3.h:85-89)."""
    xy0 = (v[..., 0] == 0.0) & (v[..., 1] == 0.0)
    t = normalize(torch.stack([v[..., 1], -v[..., 0], torch.zeros_like(v[..., 0])], -1))
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    return torch.where(xy0[..., None], ex, t)


def rotate(v: torch.Tensor, axis: torch.Tensor, angle) -> torch.Tensor:
    """Rodrigues rotation of ``v`` about unit ``axis`` (Vec3.h:99-115)."""
    angle = torch.as_tensor(angle, dtype=v.dtype, device=v.device)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    ax_dot_v = dot(axis, v)[..., None]
    rot = v * c + cross(axis, v) * s + axis * ax_dot_v * (1.0 - c)
    return torch.where(torch.abs(angle)[..., None] < M_EPS, v, rot)


def any_near_zero(v: torch.Tensor) -> torch.Tensor:
    """True when ANY component is within M_EPS of zero (Vec3.h:72-79)."""
    return (torch.abs(v) < M_EPS).any(-1)


def mean_power(v: torch.Tensor) -> torch.Tensor:
    """Lobe power = mean of the channels (Vec3.h:116-119)."""
    return v.mean(-1)


def orthonormal_frame(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless (t, b) with (t, b, n) orthonormal (Duff et al.)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    t2 = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t1, t2
