"""One segment of the regen photon walk as hand-written CUDA kernels.

``csrc/walk.cu`` holds three kernels that run one segment of
``render/photon.regen_segment`` around the Bezier compaction and the Newton
kernel, which stay as they are (``geometry/bezier.solve_gated``):
``refill`` (refill, the nearest plane and sphere hit, the Bezier box gate),
``bezier`` (each compacted winner's normal, into its lane's row) and
``shade`` (merge, record, roulette continuation).  :class:`WalkScene`
holds the scene's side, built once a walk; its ``segment`` is the CUDA
path; its plain twin is the op code of ``render/photon.py``
(``regen_segment_plain``), which ``regen_segment`` runs on CPU tensors and
under autograd.  The kernels replace no TPU kernel (see the source note).
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from ..geometry.bezier import solve_gated, solve_winner
from .cuda_build import CudaKernel

#: csrc/walk.cu's threads a block (kThreads).
THREADS = 256


class _Scene(ctypes.Structure):
    """csrc/walk.cu's ``WalkScene``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "plane_p0", "plane_n", "plane_umod", "plane_vmod", "sph_c", "sph_r", "sph_tu",
        "sph_tv", "mat", "obj_color", "obj_tex", "atlas", "light_pos", "light_color",
        "ctrl")] + [(n, ctypes.c_int) for n in (
            "P", "S", "L", "nobj", "T", "H", "W", "B", "uv_quirk")]


class _Lanes(ctypes.Structure):
    """csrc/walk.cu's ``WalkLanes``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "o", "d", "f", "alive", "depth", "rr_off", "emitted", "lid", "z", "phi", "ur", "u1",
        "u2", "o_r", "d_r", "f_r", "t_a", "obj_a", "ins_a", "gate", "rows", "partial", "pos",
        "nrm", "valid", "nd", "nf", "alive_out", "depth_out", "rr_off_out",
        "emitted_out")] + [(n, ctypes.c_int) for n in ("n", "segs", "debias", "blocks")]


REFILL = CudaKernel("walk.cu", "rt3_walk_refill", [ctypes.c_void_p, ctypes.c_void_p],
                    name="walk_refill")
BEZIER = CudaKernel("walk.cu", "rt3_walk_bezier", [
    ctypes.c_int, ctypes.c_int,                                 # cap, lanes
    ctypes.c_void_p, ctypes.c_void_p,                           # idx, dir
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,          # t, u, v
    ctypes.c_void_p, ctypes.c_void_p,                           # pid, hit
    ctypes.c_void_p, ctypes.c_void_p,                           # ctrl, rows
], name="walk_bezier")
SHADE = CudaKernel("walk.cu", "rt3_walk_shade", [ctypes.c_void_p, ctypes.c_void_p],
                   name="walk_shade")


def _p(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


def segment_bytes(n: int, n_lights: int = 1) -> int:
    """The least bytes a segment of ``n`` lanes moves, each input read and
    each output written once: the carry in (36 + 1 + 4 a lane), the five
    draws (20), the carry out (36 + 1 + 4) and the rest of the record (the
    normal, the arrival flux and the valid flag, 25; the position is the
    carry's); with more than one light, each lane's light (8).  The scene's
    tables (planes, spheres, materials, the atlas, the control points) are
    small, read by every lane and stay in L1/L2, so they count nothing."""
    return n * (41 + 20 + 41 + 25 + (8 if n_lights > 1 else 0))


def kernel_bytes(n: int, rays: int, solved: int, n_lights: int = 1) -> dict:
    """The bytes each kernel reads and writes at least, as the segment is
    split (the scene's tables count nothing, as in :func:`segment_bytes`):
    ``refill`` reads the carry's o, d, f and alive and the draws z and phi
    (45 a lane, and the lane's light with more than one) and writes the
    refilled o, d, f, the analytic hit (t, object, inside), the gate and
    the Bezier row (74); ``bezier`` reads a compacted ray's index (8 of
    each of ``rays`` slots) and, for the ``solved`` slots that hold a ray,
    its direction, t, u, v, patch and hit (29) and writes its row (28);
    ``shade`` reads alive, depth, the refilled lanes, the analytic hit, the
    gate, the row and three draws (91) and writes the record and the carry
    (54)."""
    return {"walk_refill": n * (45 + (8 if n_lights > 1 else 0) + 74),
            "walk_bezier": rays * 8 + solved * (29 + 28),
            "walk_shade": n * (91 + 54)}


class WalkScene:
    """The scene's side of the kernels, built once a walk: its tables as
    float32 (the material ``table`` of ``photon._material_lanes``) and the
    lights, kept alive with the ``WalkScene`` struct that points at them."""

    def __init__(self, scene, table: torch.Tensor, light_pos: torch.Tensor,
                 light_color: torch.Tensor):
        P, S = scene.n_planes, scene.n_spheres
        if P < 1 or S < 1:
            raise ValueError(f"the walk kernels need a plane and a sphere, got {P} and {S}")
        planes, spheres = scene.planes, scene.spheres
        self.scene = scene
        self.n_lights = light_pos.shape[0]
        self._keep = [_f32(x) for x in (
            planes.p0, planes.normal, planes.tex_u_mod, planes.tex_v_mod, spheres.center,
            spheres.radius, spheres.tex_u, spheres.tex_v, table, scene.obj_color)] + [
            scene.obj_tex.to(torch.int32).contiguous()] + [
            _f32(x) for x in (scene.atlas, light_pos, light_color)]
        self.ctrl = _f32(scene.bezier.ctrl) if scene.has_bezier else None
        T, H, W = scene.atlas.shape[:3]
        self.struct = _Scene(*[x.data_ptr() for x in self._keep], _p(self.ctrl), P, S,
                             self.n_lights, scene.n_objects, T, H, W,
                             0 if self.ctrl is None else self.ctrl.shape[0],
                             int(scene.bezier_uv_quirk))

    def segment(self, draws: tuple, carry, segs: int, debias_roulette: bool, newton_fn=None):
        """``render/photon.regen_segment`` on CUDA tensors: (new carry,
        record).  ``draws``: the segment's (z, phi, roulette, u1, u2).
        Nothing here reads the card's results on the host."""
        w = SegmentLanes(self, draws, carry, segs, debias_roulette)
        w.refill()
        if self.ctrl is not None:
            scene = self.scene
            solver = newton_fn if newton_fn is not None else partial(
                solve_winner, iters=scene.newton_iters, restarts=scene.newton_restarts)
            idx, d_c, (t, u, v, pid, hit) = solve_gated(
                w.o_r, w.d_r, scene.bezier.ctrl, w.gate, solver, scene.bezier_compact_frac)
            bezier_rows(w.rows, idx, d_c, t, u, v, pid, hit, self.ctrl)
        w.shade()
        return w.out


class SegmentLanes:
    """The tensors of one segment and the ``WalkLanes`` struct that points
    at them; :meth:`refill` and :meth:`shade` launch the kernels on them
    (each launch writes only its outputs, so either may run again)."""

    def __init__(self, ws: WalkScene, draws: tuple, carry, segs: int, debias_roulette: bool):
        o, d, f, alive, depth, rr_off, emitted = carry
        self.dev = dev = o.device
        N = o.shape[0]
        L = ws.n_lights
        blocks = -(-N // THREADS)
        lid = None
        if L > 1:
            need = ~alive
            rank = torch.cumsum(need.to(torch.int32), 0) - 1
            lid = ((rr_off + torch.clamp_min(rank, 0)) % L).contiguous()
        z, phi, ur, u1, u2 = (x.contiguous() for x in draws)
        c_in = [x.contiguous() for x in (o, d, f, alive, depth, rr_off, emitted)]
        _check(dev, c_in, (z, phi, ur, u1, u2), N, L)
        v3 = lambda: torch.empty((N, 3), dtype=torch.float32, device=dev)
        one = lambda dtype, shape=(N,): torch.empty(shape, dtype=dtype, device=dev)
        self.o_r, self.d_r, self.f_r = v3(), v3(), v3()
        bez = ws.ctrl is not None
        self.gate = one(torch.bool) if bez else None
        self.rows = one(torch.float32, (N, 7)) if bez else None
        pos, nrm, nd, nf = v3(), v3(), v3(), v3()
        valid, alive_out, depth_out = one(torch.bool), one(torch.bool), one(torch.int32)
        rr_off_out, emitted_out = one(torch.int32, ()), one(torch.float32, (L,))
        t_a, obj_a, ins_a = one(torch.float32), one(torch.int32), one(torch.bool)
        partial_ = one(torch.int32, (blocks,))
        self.ws = ws
        self._keep = (c_in, lid, z, phi, ur, u1, u2, t_a, obj_a, ins_a, partial_)
        self.struct = _Lanes(*[_p(x) for x in c_in], _p(lid),
                             *[_p(x) for x in (z, phi, ur, u1, u2)],
                             *[_p(x) for x in (self.o_r, self.d_r, self.f_r, t_a, obj_a, ins_a,
                                               self.gate, self.rows, partial_, pos, nrm, valid,
                                               nd, nf, alive_out, depth_out, rr_off_out,
                                               emitted_out)],
                             N, segs, int(debias_roulette), blocks)
        self.out = ((pos, nd, nf, alive_out, depth_out, rr_off_out, emitted_out),
                    (pos, nrm, self.f_r, valid))

    def refill(self) -> None:
        REFILL.launch(self.dev, ctypes.addressof(self.ws.struct), ctypes.addressof(self.struct))

    def shade(self) -> None:
        SHADE.launch(self.dev, ctypes.addressof(self.ws.struct), ctypes.addressof(self.struct))


def bezier_rows(rows: torch.Tensor, idx: torch.Tensor | None, dir: torch.Tensor,
                t: torch.Tensor, u: torch.Tensor, v: torch.Tensor, pid: torch.Tensor,
                hit: torch.Tensor, ctrl: torch.Tensor, kernel: CudaKernel = BEZIER) -> None:
    """Write each solved ray's (t, u, v, hit, normal) into row ``idx[j]``
    of ``rows`` (N, 7) (row j without ``idx``); fill slots (``idx`` = N)
    write nothing.  ``kernel``: the handle that launches and counts it (the
    eye's is ``eye_kernel.BEZIER``)."""
    dev = rows.device
    cap = t.shape[0]
    a = [x.contiguous() for x in (dir, t, u, v, pid.to(torch.int32), hit, ctrl)]
    if idx is not None:
        idx = idx.contiguous()
    kernel.launch(dev, cap, rows.shape[0], _p(idx), *[_p(x) for x in a], _p(rows))


def _check(dev, carry, draws, N: int, L: int) -> None:
    o, d, f, alive, depth, rr_off, emitted = carry
    want = [(o, torch.float32, (N, 3)), (d, torch.float32, (N, 3)), (f, torch.float32, (N, 3)),
            (alive, torch.bool, (N,)), (depth, torch.int32, (N,)), (rr_off, torch.int32, ()),
            (emitted, torch.float32, (L,))] + [(x, torch.float32, (N,)) for x in draws]
    for x, dtype, shape in want:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"walk kernel input {tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"expected {shape} {dtype} on {dev}")
