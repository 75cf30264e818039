"""Cubic Bezier patches: Bernstein evaluation and the ray-object hit.

Port of ``raytrace3_tpu/geometry/bezier.py``.  Two winner-contract solvers
find the nearest root per ray: :func:`solve_winner`, the JAX package's
default (plain PyTorch Newton over a ``restarts x restarts`` stratified
start grid with patch pruning, ``newton_patch_solve``), and
``ops/newton_kernel.solve`` (the CUDA kernel at 8 restarts, the ``--pallas``
path), passed in as ``newton_fn``.  Either runs without autograd;
:func:`winner_root` wraps it so that gradients reach the rays and the
control points by the implicit function theorem at the root, as the JAX
package's ``winner_root`` does.  ``load_bpt`` and ``teapot_transform`` are
host-side numpy, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..core.types import Record
from ..core.vecmath import M_EPS, MAX_DIST, cross, dot, norm2, normalize
from ..ops.compact import compact_indices_keyed
from ..ops.solve3 import solve3_columns
from ..utils.trace import count_bezier_compaction
from .aabb import aabb_from_points, slab_test

#: Reference Newton iteration budget (Bezier.h:6 ``MAX_ITER 10``).
DEFAULT_NEWTON_ITERS = 10
#: Side of :func:`solve_winner`'s stratified restart grid: 4 x 4 starts in
#: place of the reference's 50 random restarts (Bezier.h:115).
DEFAULT_RESTART_GRID = 4
#: :func:`solve_winner` works on at most this many (ray, patch, start)
#: lanes at a time; rays are independent, so the chunking changes nothing.
MAX_SOLVE_LANES = 1 << 22


@dataclass
class BezierObject(Record):
    """One Bezier object = a bag of bicubic patches (the teapot: B=32)."""

    ctrl: torch.Tensor  # (B, 4, 4, 3); ctrl[b, i, k]: i pairs with the v
    #                     basis and k with the u basis (Bezier.h:85-90)

    @property
    def num_patches(self) -> int:
        return self.ctrl.shape[0]


def bernstein(t: torch.Tensor) -> torch.Tensor:
    """Cubic Bernstein basis, (...,) -> (..., 4) (Bezier.h:69-76)."""
    s = 1.0 - t
    return torch.stack([s * s * s, 3.0 * t * s * s, 3.0 * t * t * s, t * t * t], -1)


def dbernstein(t: torch.Tensor) -> torch.Tensor:
    """Its derivative, (...,) -> (..., 4) (Bezier.h:77-84)."""
    s = 1.0 - t
    return torch.stack([-3.0 * s * s, 3.0 * s * s - 6.0 * t * s,
                        6.0 * t * s - 3.0 * t * t, 3.0 * t * t], -1)


def _contract_v(b: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """sum_i b_i ctrl[..., i, k, c] -> (..., 4, 3), no matmul."""
    return (b[..., :, None, None] * ctrl).sum(-3)


def _contract_u(b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_k b_k g[..., k, c] -> (..., 3)."""
    return (b[..., :, None] * g).sum(-2)


def patch_point(ctrl: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """S(u, v) = b(v)^T G b(u) for ctrl (..., 4, 4, 3) (Bezier.h:85-90)."""
    return _contract_u(bernstein(u), _contract_v(bernstein(v), ctrl))


def patch_tangents(ctrl: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(dS/du, dS/dv) (Bezier.h:92-111)."""
    su = _contract_u(dbernstein(u), _contract_v(bernstein(v), ctrl))
    sv = _contract_u(bernstein(u), _contract_v(dbernstein(v), ctrl))
    return su, sv


def restart_grid(g: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Stratified (u0, v0) cell centres, (g * g, 2), ``meshgrid(ij)`` order."""
    c = (torch.arange(g, dtype=dtype, device=device) + 0.5) / g
    uu, vv = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)


def _grid_derivs(ctrl: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(S, Su, Sv) of patch b at (R, B, G) parameters, ctrl (B, 4, 4, 3):
    the v basis contracted once, then the u basis (JAX ``patch_derivs``)."""
    bu, bv = bernstein(u), bernstein(v)
    gv = torch.einsum("rbgi,bikc->rbgkc", bv, ctrl)
    hv = torch.einsum("rbgi,bikc->rbgkc", dbernstein(v), ctrl)
    s = torch.einsum("rbgk,rbgkc->rbgc", bu, gv)
    su = torch.einsum("rbgk,rbgkc->rbgc", dbernstein(u), gv)
    sv = torch.einsum("rbgk,rbgkc->rbgc", bu, hv)
    return s, su, sv


def _grid_point(ctrl: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    gv = torch.einsum("rbgi,bikc->rbgkc", bernstein(v), ctrl)
    return torch.einsum("rbgk,rbgkc->rbgc", bernstein(u), gv)


def newton_patch_solve(org: torch.Tensor, dir: torch.Tensor, ctrl: torch.Tensor,
                       iters: int = DEFAULT_NEWTON_ITERS,
                       restarts: int = DEFAULT_RESTART_GRID):
    """Batched Newton root-find of ``org + t dir = S(u, v)`` (Bezier.h:112-159).

    Every (ray, patch) pair starts from the ``restarts x restarts`` grid
    with t0 the start point projected onto the ray, takes ``iters`` clamped
    Cramer steps, and keeps the nearest root accepted after any step
    (residual^2 < ``residual2_eps``, u, v in [0, 1] (+ slack), t > M_EPS).
    Returns (t, u, v, hit), each (R, B); t = MAX_DIST where nothing was
    accepted.
    """
    R, B = org.shape[0], ctrl.shape[0]
    starts = restart_grid(restarts, org.dtype, org.device)      # (G, 2)
    G = starts.shape[0]
    o = org[:, None, None, :]
    d = dir[:, None, None, :]
    u = starts[:, 0].expand(R, B, G)
    v = starts[:, 1].expand(R, B, G)
    s0 = _grid_point(ctrl, u, v)
    t = dot(s0 - o, d) / norm2(d)
    best_t = torch.full((R, B, G), MAX_DIST, dtype=org.dtype, device=org.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    for _ in range(iters):
        s, su, sv = _grid_derivs(ctrl, u, v)
        r = (o + t[..., None] * d) - s
        dt, du, dv, ok = solve3_columns(d.expand_as(r), -su, -sv, -r)
        # Clamped steps and iterates: diverging starts stay finite.
        dt = torch.clamp(dt, -1e4, 1e4)
        du = torch.clamp(du, -8.0, 8.0)
        dv = torch.clamp(dv, -8.0, 8.0)
        t = torch.clamp(t + torch.where(ok, dt, 0.0), -1e4, 1e4)
        u = torch.clamp(u + torch.where(ok, du, 0.0), -8.0, 8.0)
        v = torch.clamp(v + torch.where(ok, dv, 0.0), -8.0, 8.0)
        res2 = norm2((o + t[..., None] * d) - _grid_point(ctrl, u, v))
        accept = ((res2 < M_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                  & (v <= 1.0) & (t > M_EPS) & (t < best_t))
        best_t = torch.where(accept, t, best_t)
        best_u = torch.where(accept, u, best_u)
        best_v = torch.where(accept, v, best_v)
    gi = torch.argmin(best_t, -1, keepdim=True)                  # first minimum
    take = lambda a: torch.gather(a, -1, gi)[..., 0]
    t_rb = take(best_t)
    return t_rb, take(best_u), take(best_v), t_rb < MAX_DIST


def solve_winner(org: torch.Tensor, dir: torch.Tensor, ctrl: torch.Tensor,
                 iters: int = DEFAULT_NEWTON_ITERS,
                 restarts: int = DEFAULT_RESTART_GRID):
    """Winner contract ``(t, u, v, patch_id, hit)``, each (R,): the nearest
    root over all patches of :func:`newton_patch_solve`, with roots on
    patches whose box the ray misses dropped (JAX's ``patch_prune``, always
    on).  Plain PyTorch on any device; rays go through in chunks of at most
    ``MAX_SOLVE_LANES`` (ray, patch, start) lanes."""
    R, B = org.shape[0], ctrl.shape[0]
    step = max(1, MAX_SOLVE_LANES // (B * restarts * restarts))
    pmin, pmax = aabb_from_points(ctrl.reshape(B, 16, 3))
    parts = []
    for r0 in range(0, R, step):
        o, d = org[r0:r0 + step], dir[r0:r0 + step]
        t, u, v, hit = newton_patch_solve(o, d, ctrl, iters, restarts)
        hit = hit & slab_test(o[:, None, :], d[:, None, :], pmin[None], pmax[None])
        t = torch.where(hit, t, MAX_DIST)
        bi = torch.argmin(t, -1, keepdim=True)
        t_b = torch.gather(t, 1, bi)[:, 0]
        parts.append((t_b, torch.gather(u, 1, bi)[:, 0], torch.gather(v, 1, bi)[:, 0],
                      bi[:, 0].to(torch.int32), t_b < MAX_DIST))
    if not parts:
        z = org.new_zeros((0,))
        return z, z, z, z.to(torch.int32), z.to(torch.bool)
    return tuple(torch.cat(x) for x in zip(*parts))


class _WinnerRoot(torch.autograd.Function):
    """Forward: the solver on detached inputs.  Backward: the implicit
    function theorem at the root as returned, for F(t, u, v; org, dir,
    ctrl) = org + t dir - S(u, v; ctrl) = 0 with J = [dir | -Su | -Sv]:
    w = J^-T (g_t, g_u, g_v), then d_org = -w, d_dir = -t w and d_ctrl =
    (dS/dctrl)^T w, scattered per patch (JAX ``_winner_bwd``)."""

    @staticmethod
    def forward(ctx, org, dir, ctrl, solver):
        t, u, v, pid, hit = solver(org.detach().contiguous(),
                                   dir.detach().contiguous(),
                                   ctrl.detach().contiguous())
        ctx.mark_non_differentiable(pid, hit)
        ctx.save_for_backward(dir, ctrl, t, u, v, pid, hit)
        return t, u, v, pid, hit

    @staticmethod
    def backward(ctx, g_t, g_u, g_v, _g_pid, _g_hit):
        dir, ctrl, t, u, v, pid, hit = ctx.saved_tensors
        g = torch.stack([torch.where(hit, g_t, 0.0), torch.where(hit, g_u, 0.0),
                         torch.where(hit, g_v, 0.0)], -1)          # (R, 3)
        pid = pid.long()
        # Linearised at the root the forward returned, not a polished one.
        su, sv = patch_tangents(ctrl[pid], u, v)
        # J^T w = g: the rows of J are (dir_c, -su_c, -sv_c), c = x, y, z.
        rows = [torch.stack([dir[:, c], -su[:, c], -sv[:, c]], -1) for c in range(3)]
        w0, w1, w2, ok = solve3_columns(*rows, g)
        w = torch.where((hit & ok)[:, None], torch.stack([w0, w1, w2], -1), 0.0)
        d_org = -w
        d_dir = -t[:, None] * w
        bu, bv = bernstein(u), bernstein(v)                         # (R, 4)
        contrib = (bv[:, :, None, None] * bu[:, None, :, None]
                   * w[:, None, None, :])                           # (R, 4, 4, 3)
        d_ctrl = torch.zeros_like(ctrl).index_add_(0, pid, contrib)
        return d_org, d_dir, d_ctrl, None


def winner_root(org: torch.Tensor, dir: torch.Tensor, ctrl: torch.Tensor, solver):
    """``solver(org, dir, ctrl) -> (t, u, v, patch_id, hit)``, differentiable
    in ``org``, ``dir`` and ``ctrl`` through (t, u, v) by the implicit
    function theorem (O(1) memory, exact at the root); ``patch_id`` and
    ``hit`` carry no gradient."""
    return _WinnerRoot.apply(org, dir, ctrl, solver)


def default_solver(newton_fn=None, iters: int = DEFAULT_NEWTON_ITERS,
                   restarts: int = DEFAULT_RESTART_GRID):
    """The winner-contract solver a Bezier hit uses: ``newton_fn``, or
    :func:`solve_winner` at ``iters`` and ``restarts`` where it is None."""
    return newton_fn if newton_fn is not None else partial(
        solve_winner, iters=iters, restarts=restarts)


def intersect_bezier(org: torch.Tensor, dir: torch.Tensor, obj: BezierObject,
                     iters: int = DEFAULT_NEWTON_ITERS,
                     restarts: int = DEFAULT_RESTART_GRID,
                     newton_fn=None, compact_frac: float = 1.0):
    """Nearest ray-object hit over all patches (Bezier.h:240-282).

    Object-AABB gate, the winner-contract Newton solve, and the winner's
    normal Su x Sv flipped toward the viewer.  ``compact_frac`` < 1 gathers
    only the rays that pass the object AABB into a buffer of
    ``max(8, int(R * compact_frac))`` lanes before the solve; gated rays
    beyond that capacity count as misses.  Inside a pass's tally
    (``utils.trace.bezier_tally``) each compaction adds its gated count,
    which the pass reports as ``bezier_overflow`` and lane use.

    ``newton_fn``: a winner-contract solver ``(org, dir, ctrl) ->
    (t, u, v, patch_id, hit)``, e.g. ``newton_kernel.make_newton()``;
    defaults to :func:`solve_winner` at ``iters`` and ``restarts``, as in
    the JAX package.  Either way the solve goes
    through :func:`winner_root`, so gradients flow by the IFT.

    Returns (t, hit, u, v, n): t (R,), hit (R,), u/v (R,), n (R, 3).
    """
    ctrl = obj.ctrl
    pmin, pmax = aabb_from_points(ctrl.reshape(obj.num_patches, 16, 3))
    obj_gate = slab_test(org, dir, pmin.amin(0), pmax.amax(0))
    solver = default_solver(newton_fn, iters, restarts)

    def winner_normal(d, u, v, pid):
        su, sv = patch_tangents(ctrl[pid.long()], u, v)
        n = cross(su, sv)
        n = torch.where(dot(n, d)[..., None] > 0.0, -n, n)
        return normalize(n)

    R = org.shape[0]
    idx, dir_s, (t_s, u_s, v_s, pid_s, hit_s) = solve_gated(org, dir, ctrl, obj_gate, solver,
                                                            compact_frac)
    n_s = winner_normal(dir_s, u_s, v_s, pid_s)
    if idx is not None:
        rows = torch.cat([t_s[:, None], u_s[:, None], v_s[:, None],
                          hit_s.to(dir.dtype)[:, None], n_s], 1)  # (cap, 7)
        # Misses read t = MAX_DIST, n = (0, 0, 1); row R takes the fill
        # slots and is cut off.
        out = torch.zeros((R + 1, 7), dtype=dir.dtype, device=dir.device)
        out[:, 0] = MAX_DIST
        out[:, 6] = 1.0
        out[idx] = rows
        t_best, u_best, v_best = out[:R, 0], out[:R, 1], out[:R, 2]
        hit = out[:R, 3] > 0.5
        n = out[:R, 4:7]
    else:
        t_best, u_best, v_best, hit, n = t_s, u_s, v_s, hit_s, n_s

    hit = hit & obj_gate
    return torch.where(hit, t_best, MAX_DIST), hit, u_best, v_best, n


def compact_lanes(R: int, compact_frac: float) -> int:
    """The lanes a Bezier solve of ``R`` rays compacts its gated rays
    into: ``max(8, int(R * compact_frac))``, or R (no compaction) for
    ``compact_frac`` >= 1."""
    return R if compact_frac >= 1.0 else max(8, int(R * compact_frac))


def solve_gated(org: torch.Tensor, dir: torch.Tensor, ctrl: torch.Tensor, gate: torch.Tensor,
                solver, compact_frac: float):
    """The winner-contract solve of the rays that pass the object gate:
    (idx, the solved rays' directions, (t, u, v, patch_id, hit)).

    Where :func:`compact_lanes` is below R, gathers the gated rays, in
    order, into that many lanes (``idx``: each lane's ray, R for a fill
    lane, whose ray is ray R - 1) and solves those; otherwise every ray is
    solved and ``idx`` is None.  Inside a pass's tally the compaction adds
    its gated count.  The card's segment kernels compact in one kernel to
    the same lanes (``ops/walk_kernel.WalkScene.solve``); this is their
    plain twin."""
    R = org.shape[0]
    cap = compact_lanes(R, compact_frac)
    if cap >= R:
        return None, dir, winner_root(org, dir, ctrl, solver)
    idx, org_c, dir_c, key = compact_rays(org, dir, gate, cap)
    count_bezier_compaction(key, cap)
    return idx, dir_c, winner_root(org_c, dir_c, ctrl, solver)


def compact_rays(org: torch.Tensor, dir: torch.Tensor, gate: torch.Tensor, cap: int):
    """The gated rays gathered, in order, into ``cap`` lanes: (idx (cap,),
    their origins and directions (cap, 3), the sorted key the lanes are
    ranked by); a fill lane's index is R and its ray is ray R - 1.  The
    plain twin of the card's ``walk_compact`` kernel."""
    R = org.shape[0]
    idx, key = compact_indices_keyed(gate, cap, fill=R)            # (cap,)
    od_c = torch.cat([org, dir], 1)[torch.clamp_max(idx, R - 1)]
    return idx, od_c[:, 0:3].contiguous(), od_c[:, 3:6].contiguous(), key


def load_bpt(path: str, scale: float = 1.0, transform: np.ndarray | None = None,
             translate=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Parse a Newell-format ``.bpt`` patch file -> (B, 4, 4, 3) float32,
    applying p -> transform @ (scale * p) + translate (Scene.h:142-154)."""
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)
    nxt = lambda: next(it)
    b = int(nxt())
    out = np.empty((b, 4, 4, 3), np.float64)
    tr = np.eye(3) if transform is None else np.asarray(transform, np.float64)
    c = np.asarray(translate, np.float64)
    for p in range(b):
        m, n = int(nxt()), int(nxt())
        if (m, n) != (3, 3):
            raise ValueError(f"patch {p}: only bicubic supported, got {m}x{n}")
        pts = np.array([[float(nxt()) for _ in range(3)] for _ in range(16)])
        pts = (tr @ (pts * scale).T).T + c
        out[p] = pts.reshape(4, 4, 3)
    return out.astype(np.float32)


def teapot_transform() -> np.ndarray:
    """The reference teapot orientation (Scene.h:142-152): Trans swaps y/z,
    Trans2 rotates 90 deg about y; composed Trans2 @ Trans."""
    trans = np.zeros((3, 3))
    trans[0, 0] = 1.0
    trans[1, 2] = 1.0
    trans[2, 1] = 1.0
    th = np.pi / 2.0
    trans2 = np.array(
        [
            [np.cos(th), 0.0, np.sin(th)],
            [0.0, 1.0, 0.0],
            [-np.sin(th), 0.0, np.cos(th)],
        ]
    )
    return trans2 @ trans
