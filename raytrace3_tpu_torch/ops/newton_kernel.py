"""Ray x Bezier-patch Newton solve: the CUDA kernel and its plain twin.

Port of ``raytrace3_tpu/ops/newton_pallas.py``.  ``solve(org, dir, ctrl)``
returns the winner contract ``(t, u, v, patch_id, hit)``, each (R,), that
``geometry.bezier.intersect_bezier`` consumes.  For CUDA tensors it launches
``csrc/newton.cu``; for CPU tensors it runs :func:`solve_plain`, a batched
tensor program over (rays x patch lanes) with the kernel's exact contract
(see the source note in ``csrc/newton.cu``).  There is no other path.

The 128-lane coefficient-row layout of the TPU kernel exists to fill the
TPU's vector unit; what survives of it here is the lane grouping, because
the winner's tie rules are defined per group of 128 lanes.  The kernel
runs only the lanes whose patch box the ray opens and combines them in no
fixed order (:func:`fold_winner` is the fold it must equal;
:func:`drain_schedule` counts its work).
"""

from __future__ import annotations

import ctypes
import math
from functools import partial

import numpy as np
import torch

from ..core.vecmath import M_EPS, MAX_DIST
from .cuda_build import CudaKernel, check, ptr

LANES = 128
#: Total restarts per patch (a 2 x 4 stratified grid), the bench default.
DEFAULT_RESTARTS = 8
BIG = float(MAX_DIST)
#: csrc/newton.cu's compiled constants: threads a block (kThreads), rays a
#: block (kRaysPerBlock), open (ray, patch) pairs its queue holds (kQueue)
#: and the most patches it takes (kMaxPatches, a queue entry packs the
#: patch in 8 bits).  A CPU test reads them back from the source.
THREADS = 256
RAYS_PER_BLOCK = 8
QUEUE = 1024
MAX_PATCHES = 256

KERNEL = CudaKernel("newton.cu", "rt3_newton_solve", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # org, dir, ctrl
    ctypes.c_int, ctypes.c_int, ctypes.c_int,               # R, B, restarts
    ctypes.c_int, ctypes.c_int, ctypes.c_int,               # gu, gv, iters
    ctypes.c_float,                                         # res2_eps
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # t, u, v
    ctypes.c_void_p, ctypes.c_void_p,                       # pid, hit
])


def restart_grid_shape(restarts: int) -> tuple[int, int]:
    """(gu, gv) with gu * gv = restarts, gu the largest divisor <= sqrt."""
    if restarts < 1 or LANES % restarts:
        raise ValueError(f"restarts must divide {LANES}, got {restarts}")
    gu = math.isqrt(restarts)
    while restarts % gu:
        gu -= 1
    return gu, restarts // gu


def uv0_table(restarts: int) -> np.ndarray:
    """(restarts, 2) float32 start (u0, v0) per restart, cell centres of the
    gu x gv grid in ``meshgrid(indexing="ij")`` order (``_uv0_rows``)."""
    gu, gv = restart_grid_shape(restarts)
    uu, vv = np.meshgrid((np.arange(gu) + 0.5) / gu, (np.arange(gv) + 0.5) / gv,
                         indexing="ij")
    return np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)


def _bern(t):
    s = 1.0 - t
    return s * s * s, 3.0 * t * s * s, 3.0 * t * t * s, t * t * t


def _dbern(t):
    s = 1.0 - t
    return (-3.0 * s * s, 3.0 * s * s - 6.0 * t * s,
            6.0 * t * s - 3.0 * t * t, 3.0 * t * t)


def _patch_eval(g, u, v, want_derivs: bool):
    """S (and Su, Sv) for per-lane control points ``g`` (L, 16, 3) at
    (R, L) parameters, summed in the kernel's order."""
    bu, bv = _bern(u), _bern(v)
    if want_derivs:
        du, dv = _dbern(u), _dbern(v)
    s, su, sv = [None] * 3, [None] * 3, [None] * 3
    for c in range(3):
        acc = accu = accv = 0.0
        for i in range(4):
            rowu = rowdu = 0.0
            for k in range(4):
                gik = g[:, i * 4 + k, c]
                rowu = rowu + bu[k] * gik
                if want_derivs:
                    rowdu = rowdu + du[k] * gik
            acc = acc + bv[i] * rowu
            if want_derivs:
                accu = accu + bv[i] * rowdu
                accv = accv + dv[i] * rowu
        s[c], su[c], sv[c] = acc, accu, accv
    return s, su, sv


def box_open(org: torch.Tensor, dir: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """(R, P) the kernel's gate: whether ray r meets box p ([lo, hi], each
    (P, 3)) at some t >= 0, by the slab test in the kernel's operation
    order; a NaN slab (0 * inf) opens the slab, as in the TPU kernel."""
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    inv_x, inv_y, inv_z = 1.0 / dir[:, 0:1], 1.0 / dir[:, 1:2], 1.0 / dir[:, 2:3]
    t0x, t1x = (lo[:, 0] - ox) * inv_x, (hi[:, 0] - ox) * inv_x
    t0y, t1y = (lo[:, 1] - oy) * inv_y, (hi[:, 1] - oy) * inv_y
    t0z, t1z = (lo[:, 2] - oz) * inv_z, (hi[:, 2] - oz) * inv_z
    nanfix = lambda x, rep: torch.where(torch.isnan(x), rep, x)
    tnear = torch.maximum(
        torch.maximum(nanfix(torch.minimum(t0x, t1x), -BIG),
                      nanfix(torch.minimum(t0y, t1y), -BIG)),
        nanfix(torch.minimum(t0z, t1z), -BIG))
    tfar = torch.minimum(
        torch.minimum(nanfix(torch.maximum(t0x, t1x), BIG),
                      nanfix(torch.maximum(t0y, t1y), BIG)),
        nanfix(torch.maximum(t0z, t1z), BIG))
    return tfar >= torch.clamp_min(tnear, 0.0)


def open_pairs(org: torch.Tensor, dir: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """(R, B) the (ray, patch) pairs whose patch box the ray opens: the
    pairs the kernel runs Newton lanes for."""
    g = ctrl.reshape(ctrl.shape[0], 16, 3)
    return box_open(org, dir, g.amin(1), g.amax(1))


def solve_plain(org: torch.Tensor, dir: torch.Tensor, ctrl: torch.Tensor,
                iters: int = 10, restarts: int = DEFAULT_RESTARTS,
                residual2_eps: float = M_EPS):
    """The kernel's contract as one batched tensor program over
    (rays x patch lanes); see ``csrc/newton.cu`` for the rules."""
    R, B = org.shape[0], ctrl.shape[0]
    dev = org.device
    per_group = LANES // restarts
    n_groups = -(-B // per_group)
    n_lanes = n_groups * LANES
    lane = torch.arange(n_lanes, device=dev)
    patch = lane // restarts
    valid = patch < B
    pad = torch.zeros((n_groups * per_group - B, 4, 4, 3), dtype=ctrl.dtype,
                      device=dev)
    g = torch.cat([ctrl, pad])[patch].reshape(n_lanes, 16, 3)
    uv0 = torch.as_tensor(uv0_table(restarts), device=dev)[lane % restarts]

    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dir[:, 0:1], dir[:, 1:2], dir[:, 2:3]
    box_ok = box_open(org, dir, g.amin(1), g.amax(1)) & valid

    u = uv0[:, 0].expand(R, n_lanes)
    v = uv0[:, 1].expand(R, n_lanes)
    s0, _, _ = _patch_eval(g, u, v, False)
    t = (s0[0] - ox) * dx + (s0[1] - oy) * dy + (s0[2] - oz) * dz
    best_t = torch.full_like(t, BIG)
    best_u = torch.zeros_like(t)
    best_v = torch.zeros_like(t)
    for _ in range(iters):
        s, su, sv = _patch_eval(g, u, v, True)
        rx = ox + t * dx - s[0]
        ry = oy + t * dy - s[1]
        rz = oz + t * dz - s[2]
        cx = su[1] * sv[2] - su[2] * sv[1]
        cy = su[2] * sv[0] - su[0] * sv[2]
        cz = su[0] * sv[1] - su[1] * sv[0]
        det = dx * cx + dy * cy + dz * cz
        ok = torch.abs(det) > 1e-12
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        dt = -(rx * cx + ry * cy + rz * cz) * inv_det
        ex = ry * sv[2] - rz * sv[1]
        ey = rz * sv[0] - rx * sv[2]
        ez = rx * sv[1] - ry * sv[0]
        du = (dx * ex + dy * ey + dz * ez) * inv_det
        fx = su[1] * rz - su[2] * ry
        fy = su[2] * rx - su[0] * rz
        fz = su[0] * ry - su[1] * rx
        dv = (dx * fx + dy * fy + dz * fz) * inv_det
        okf = ok.to(t.dtype)
        t = torch.clamp(t + torch.clamp(dt, -1e4, 1e4) * okf, -1e4, 1e4)
        u = torch.clamp(u + torch.clamp(du, -8.0, 8.0) * okf, -8.0, 8.0)
        v = torch.clamp(v + torch.clamp(dv, -8.0, 8.0) * okf, -8.0, 8.0)
        s2, _, _ = _patch_eval(g, u, v, False)
        ax = ox + t * dx - s2[0]
        ay = oy + t * dy - s2[1]
        az = oz + t * dz - s2[2]
        res2 = ax * ax + ay * ay + az * az
        accept = ((res2 < residual2_eps) & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (v <= 1.0) & (t > M_EPS) & (t < best_t)
                  & box_ok)
        best_t = torch.where(accept, t, best_t)
        best_u = torch.where(accept, u, best_u)
        best_v = torch.where(accept, v, best_v)

    t_out, u_out, v_out, p_out = fold_winner(best_t, best_u, best_v, patch)
    pid = torch.clamp(p_out, 0, B - 1).to(torch.int32)
    return t_out, u_out, v_out, pid, t_out < BIG * 0.5


def fold_winner(best_t: torch.Tensor, best_u: torch.Tensor, best_v: torch.Tensor,
                patch: torch.Tensor):
    """Each ray's winner ``(t, u, v, patch as float)`` from its lanes' best
    roots, (R, n_groups * 128) with ``best_t = BIG`` where a lane accepted
    none, and the lanes' patch ids (n_groups * 128,): per group of 128
    lanes the least t and the smallest u, v and patch id among the lanes
    tied at it, each on its own; across groups, in order, only a strictly
    smaller t replaces the running winner, from (BIG, 0, 0, 0)."""
    R, n_groups = best_t.shape[0], best_t.shape[1] // LANES
    shape = (R, n_groups, LANES)
    best_t, best_u, best_v = (x.reshape(shape) for x in (best_t, best_u, best_v))
    tile_min = best_t.amin(-1)
    winner = best_t <= tile_min[..., None]
    sel = lambda x: torch.where(winner, x, BIG).amin(-1)
    w_u, w_v = sel(best_u), sel(best_v)
    w_p = sel(patch.to(best_t.dtype).reshape(1, n_groups, LANES).expand(shape))
    t_out = torch.full((R,), BIG, dtype=best_t.dtype, device=best_t.device)
    u_out = torch.zeros_like(t_out)
    v_out = torch.zeros_like(t_out)
    p_out = torch.zeros_like(t_out)
    for grp in range(n_groups):
        better = tile_min[:, grp] < t_out
        t_out = torch.where(better, tile_min[:, grp], t_out)
        u_out = torch.where(better, w_u[:, grp], u_out)
        v_out = torch.where(better, w_v[:, grp], v_out)
        p_out = torch.where(better, w_p[:, grp], p_out)
    return t_out, u_out, v_out, p_out


def drain_schedule(open_pairs: torch.Tensor, restarts: int) -> dict:
    """The kernel's work on a (R, B) mask of the (ray, patch) pairs that
    open their patch box, as csrc/newton.cu schedules it: blocks of
    ``RAYS_PER_BLOCK`` rays gate ``THREADS`` pairs a round (ray-major),
    queue the open ones and drain the queue when one more round might
    overflow it and after the last round; a drain runs ``THREADS //
    restarts`` pairs a step.  Returns the blocks, the blocks that run no
    Newton, the drains, the Newton steps and the share of their lanes that
    held an open pair."""
    R, B = open_pairs.shape
    blocks = -(-R // RAYS_PER_BLOCK)
    x = torch.zeros((blocks * RAYS_PER_BLOCK, B), dtype=torch.int64)
    x[:R] = open_pairs.cpu()
    x = x.reshape(blocks, RAYS_PER_BLOCK * B)
    rounds = -(-x.shape[1] // THREADS)
    x = torch.nn.functional.pad(x, (0, rounds * THREADS - x.shape[1]))
    x = x.reshape(blocks, rounds, THREADS).sum(-1)
    per_step = THREADS // restarts
    qn = torch.zeros(blocks, dtype=torch.int64)
    drains, steps = torch.zeros_like(qn), torch.zeros_like(qn)
    for k in range(rounds):
        qn = qn + x[:, k]
        go = (qn > QUEUE - THREADS) | ((qn > 0) & (k == rounds - 1))
        drains += go.long()
        steps += torch.where(go, (qn + per_step - 1) // per_step, 0)
        qn = torch.where(go, 0, qn)
    n_steps = int(steps.sum())
    return dict(blocks=blocks, blocks_without_newton=int((drains == 0).sum()),
                drains=int(drains.sum()), steps=n_steps,
                lane_fill=int(x.sum()) * restarts / max(n_steps * THREADS, 1))


def _solve_cuda(org, dir, ctrl, iters, restarts, residual2_eps):
    dev = org.device
    R, B = org.shape[0], ctrl.shape[0]
    check("org", org, torch.float32, (R, 3), dev)
    check("dir", dir, torch.float32, (R, 3), dev)
    check("ctrl", ctrl, torch.float32, (B, 4, 4, 3), dev)
    if not 1 <= B <= MAX_PATCHES:
        raise ValueError(f"the kernel takes 1..{MAX_PATCHES} patches, got {B}")
    gu, gv = restart_grid_shape(restarts)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    pid = torch.empty((R,), dtype=torch.int32, device=dev)
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    if R > 0:
        KERNEL.launch(dev, ptr(org), ptr(dir), ptr(ctrl), R, B, restarts, gu,
                      gv, iters, residual2_eps, ptr(t), ptr(u), ptr(v),
                      ptr(pid), ptr(hit))
    return t, u, v, pid, hit


def solve(org: torch.Tensor, dir: torch.Tensor, ctrl: torch.Tensor,
          iters: int = 10, restarts: int = DEFAULT_RESTARTS,
          residual2_eps: float = M_EPS):
    """Winner contract ``(t, u, v, patch_id, hit)``, each (R,).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`solve_plain`.  ``restarts`` is the total per patch and must
    divide 128.
    """
    if org.is_cuda:
        return _solve_cuda(org, dir, ctrl, iters, restarts, residual2_eps)
    if org.device.type == "cpu":
        restart_grid_shape(restarts)
        return solve_plain(org, dir, ctrl, iters, restarts, residual2_eps)
    raise ValueError(f"no Newton solver for device {org.device}")


def make_newton(iters: int = 10, restarts: int = DEFAULT_RESTARTS,
                residual2_eps: float = M_EPS):
    """A winner-contract solver ``(org, dir, ctrl) -> (t, u, v, pid, hit)``
    (the counterpart of ``make_newton_pallas``)."""
    return partial(solve, iters=iters, restarts=restarts,
                   residual2_eps=residual2_eps)
