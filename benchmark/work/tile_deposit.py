"""Work of the photon deposit's contract: every (deposit, hit point) pair
inside the hit point's radius with agreeing normals adds one to its count
and the deposit's flux to its flux.

Operations per pair inside a radius, from the plain reference's test and
accumulate: |h - d|^2 (3 subtractions, 3 multiplies, 2 adds), n_h . n_d
(3 multiplies, 2 adds), the two comparisons, and the four adds of count
and flux: 19.  Pairs outside every radius are the implementation's
search, not the contract's work.  Bytes: each hit point's position,
normal and radius^2 in (28) and its count and flux out (16); each
deposit's position, normal, flux and valid flag in (37).
"""

from __future__ import annotations

PAIR_FLOPS = 19
HIT_BYTES = 28 + 16
DEPOSIT_BYTES = 37


def work(calls: list) -> tuple[float, float]:
    """(operations, bytes) of calls given as (pairs inside a radius, hit
    points, deposits)."""
    flops = sum(p for p, _, _ in calls) * PAIR_FLOPS
    nbytes = sum(h * HIT_BYTES + d * DEPOSIT_BYTES for _, h, d in calls)
    return float(flops), float(nbytes)
