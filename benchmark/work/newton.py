"""Work of the ray x Bezier-patch Newton solve's contract (the winner of
``restarts`` Newton starts on every patch whose box a ray meets).

Operations are counted from the plain reference's arithmetic, a multiply or
an add each, per (ray, patch, start) lane:

* the start: S(u0, v0) (two cubic bases, 11 each; four rows of 4 x 3
  multiply-adds, 84; the column sum, 21) and t0 = (S - o) . d (8): 135;
* each iteration: S, dS/du and dS/dv (two bases, 22, and their
  derivatives, 30; two row sets, 168; three column sums, 63), the residual
  (9), the Cramer solve (three cross products, 27; four dots, 20; the
  inverse, a negation and three products, 5), the three updates (6), and
  the residual of the new iterate (S again, 127; 9 and 5): 491.

The solver takes ``iters`` iterations on every lane (it has no early exit),
so an open pair costs restarts x (135 + iters x 491).  Bytes: each ray's
origin and direction in (24) and its winner out (t, u, v, patch, hit: 17),
and the patches' control points (192 each) once a call.
"""

from __future__ import annotations

START_FLOPS = 135
ITER_FLOPS = 491
RAY_BYTES = 24 + 17
PATCH_BYTES = 192


def work(calls: list, restarts: int, iters: int) -> tuple[float, float]:
    """(operations, bytes) of calls given as (open pairs, rays with an open
    pair, patches)."""
    flops = sum(p for p, _, _ in calls) * restarts * (START_FLOPS + iters * ITER_FLOPS)
    nbytes = sum(r * RAY_BYTES + b * PATCH_BYTES for _, r, b in calls)
    return float(flops), float(nbytes)
