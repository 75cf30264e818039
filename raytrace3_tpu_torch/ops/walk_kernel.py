"""A walk's segment, the photon walk's or the staged eye's, as hand-written
CUDA kernels: the rule that picks them, the scene's tables and the Bezier
middle both walks share, and the photon walk's own lanes.

``csrc/walk.cu`` holds four kernels that run one segment of
``render/photon.regen_segment``: ``refill`` (refill, the nearest plane and
sphere hit, the Bezier box gate and each block's count of gated lanes),
``compact`` (the gated rays gathered into Newton's lanes), ``bezier``
(each compacted winner's normal, into its lane's row) and ``shade``
(merge, record, roulette continuation); ``ops/eye_kernel.py`` runs the
eye's two around the same ``compact`` and ``bezier``.  :func:`kernel_tables`
is the one rule for whether a walk's segments run as kernels: once a walk,
it returns the scene's tables (:class:`WalkScene`), None off the card or
under autograd, or raises for card lanes the kernels cannot take.
:meth:`WalkScene.run` launches a segment: its first kernel, the Bezier
middle (:meth:`WalkScene.solve`: ``compact``, then Newton), the rows, and
its shade.  The plain twins are the op code of ``render/photon.py``
(``regen_segment_plain``) and ``render/eye.py`` (``eye_segment_plain``),
whose middle is ``geometry/bezier.solve_gated``.  The kernels replace no
TPU kernel (see the source note).
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from ..core.types import grad_reaches
from ..geometry.bezier import compact_lanes, default_solver
from ..utils.trace import bezier_count_slot
from . import newton_kernel
from .cuda_build import CudaKernel

#: csrc/walk.cu's threads a block (kThreads).
THREADS = 256
#: csrc/walk.cu's lanes a compaction block ranks (kCompactLanes).
COMPACT_LANES = 2048


class _Scene(ctypes.Structure):
    """csrc/surface.cuh's ``WalkScene``, the tables both walks' kernels read."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "plane_p0", "plane_n", "plane_umod", "plane_vmod", "sph_c", "sph_r", "sph_tu",
        "sph_tv", "mat", "obj_color", "obj_tex", "atlas", "light_pos", "light_color",
        "ctrl")] + [(n, ctypes.c_int) for n in (
            "P", "S", "L", "nobj", "T", "H", "W", "B", "uv_quirk")]


class _Lanes(ctypes.Structure):
    """csrc/walk.cu's ``WalkLanes``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "o", "d", "f", "alive", "depth", "rr_off", "emitted", "lid", "z", "phi", "ur", "u1",
        "u2", "o_r", "d_r", "f_r", "t_a", "obj_a", "ins_a", "gate", "rows", "partial", "gated",
        "pos", "nrm", "valid", "nd", "nf", "alive_out", "depth_out", "rr_off_out",
        "emitted_out")] + [(n, ctypes.c_int) for n in ("n", "segs", "debias", "blocks")]


REFILL = CudaKernel("walk.cu", "rt3_walk_refill", [ctypes.c_void_p, ctypes.c_void_p],
                    name="walk_refill")
#: The Bezier middle's compaction, the walk's and the eye's.
COMPACT = CudaKernel("walk.cu", "rt3_walk_compact", [
    ctypes.c_int, ctypes.c_int,                                 # lanes, cap
    ctypes.c_void_p, ctypes.c_void_p,                           # gate, gated a block
    ctypes.c_void_p, ctypes.c_void_p,                           # org, dir
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,          # idx, org_c, dir_c
    ctypes.c_void_p,                                            # gated in all
], name="walk_compact")
BEZIER = CudaKernel("walk.cu", "rt3_walk_bezier", [
    ctypes.c_int, ctypes.c_int,                                 # cap, lanes
    ctypes.c_void_p, ctypes.c_void_p,                           # idx, dir
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,          # t, u, v
    ctypes.c_void_p, ctypes.c_void_p,                           # pid, hit
    ctypes.c_void_p, ctypes.c_void_p,                           # ctrl, rows
], name="walk_bezier")
SHADE = CudaKernel("walk.cu", "rt3_walk_shade", [ctypes.c_void_p, ctypes.c_void_p],
                   name="walk_shade")


def pointer(t: torch.Tensor | None) -> int | None:
    """``t``'s device address for a kernel's struct (None for no tensor)."""
    return None if t is None else t.data_ptr()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lives where the segment kernels run (a CUDA device)."""
    return x.is_cuda


def kernel_tables(scene, table: torch.Tensor, light_pos: torch.Tensor,
                  light_color: torch.Tensor, lanes) -> WalkScene | None:
    """The kernels' tables (:class:`WalkScene`) for a walk whose first lanes
    or carry are ``lanes``, or None where no kernel path exists: lanes off
    the card (:func:`on_card`), or autograd reaching the scene, the lights
    or the lanes (the kernels have no backward).  Later lanes derive only
    from these and from draws without a gradient, so one call a walk
    decides every segment.  Card lanes the kernels cannot take (not
    float32, or a scene without a plane and a sphere) raise ValueError.
    ``table``: the walk's material table."""
    o = lanes[0]
    if not on_card(o) or grad_reaches(scene, light_pos, light_color, lanes):
        return None
    if o.dtype != torch.float32 or scene.n_planes < 1 or scene.n_spheres < 1:
        raise ValueError(f"the segment kernels take float32 lanes and a scene with a plane and "
                         f"a sphere; got {o.dtype} lanes, {scene.n_planes} planes, "
                         f"{scene.n_spheres} spheres")
    return WalkScene(scene, table, light_pos, light_color)


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
    the Bezier row (74); ``compact`` reads the gate (1 a lane), writes each
    of ``rays`` slots' index and ray (8 + 24) and reads the ray of each of
    the ``solved`` slots that hold one (24); ``bezier`` reads a compacted
    ray's index (8 a slot) and, for a slot that holds a ray, its
    direction, t, u, v, patch and hit (29) and writes its row (28);
    ``shade`` reads alive, depth, the refilled lanes, the analytic hit, the
    gate, the row and three draws (91) and writes the record and the carry
    (54)."""
    return {"walk_refill": n * (45 + (8 if n_lights > 1 else 0) + 74),
            "walk_compact": compact_bytes(n, rays, solved),
            "walk_bezier": rays * 8 + solved * (29 + 28),
            "walk_shade": n * (91 + 54)}


def compact_bytes(n: int, rays: int, solved: int) -> int:
    """The least bytes of one compaction of ``n`` lanes into ``rays``
    slots, ``solved`` of which hold a gated ray (:func:`kernel_bytes`)."""
    return n + rays * (8 + 24) + solved * 24


def block_counts(gate: torch.Tensor) -> torch.Tensor:
    """The gated lanes of each block of :data:`THREADS` lanes, int32: what
    a segment's first kernel writes for the compaction (the plain twin of
    its ``gated`` counts)."""
    pad = -gate.shape[0] % THREADS
    return torch.nn.functional.pad(gate.to(torch.int32), (0, pad)).view(-1, THREADS).sum(
        1, dtype=torch.int32)


class WalkScene:
    """The scene's side of the kernels, built once a walk by
    :func:`kernel_tables`: its tables as float32 with a walk's material
    ``table`` (``photon._material_lanes``'s or ``eye._eye_material_lanes``'s)
    and the lights, kept alive with csrc/surface.cuh's ``WalkScene`` struct
    that points at them; and the Bezier middle's buffers, made at the
    walk's first segment and sized to its widest (:meth:`gated_counts`,
    :meth:`middle`).  Every segment writes the same buffers: each reader
    of a segment's middle (its ``bezier`` and ``shade`` launches) runs
    before the next segment's ``compact`` on the one stream."""

    def __init__(self, scene, table: torch.Tensor, light_pos: torch.Tensor,
                 light_color: torch.Tensor):
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
        self.struct = _Scene(*[x.data_ptr() for x in self._keep], pointer(self.ctrl),
                             scene.n_planes, scene.n_spheres, self.n_lights, scene.n_objects,
                             T, H, W, 0 if self.ctrl is None else self.ctrl.shape[0],
                             int(scene.bezier_uv_quirk))
        self._gated = None
        self._base = None
        self._middles = {}

    def gated_counts(self, n: int) -> torch.Tensor:
        """The int32 buffer a segment of ``n`` lanes' first kernel writes its
        gated lanes a block into (at least ``ceil(n / THREADS)`` of them)."""
        blocks = -(-n // THREADS)
        if self._gated is None or self._gated.shape[0] < blocks:
            self._gated = torch.empty((blocks,), dtype=torch.int32, device=self.ctrl.device)
        return self._gated

    def middle(self, cap: int) -> tuple:
        """The middle's outputs at ``cap`` slots, views of the walk's
        buffers: (idx (cap,) int64, org_c and dir_c (cap, 3), Newton's
        (t, u, v, patch, hit), the gated count's (1,) int32 slot for a
        compaction outside a tally)."""
        views = self._middles.get(cap)
        if views is None:
            if self._base is None or self._base[0].shape[0] < cap:
                dev = self.ctrl.device
                self._base = (torch.empty((cap,), dtype=torch.int64, device=dev),
                              torch.empty((9 * cap,), dtype=torch.float32, device=dev),
                              torch.empty((cap,), dtype=torch.int32, device=dev),
                              torch.empty((cap,), dtype=torch.bool, device=dev),
                              torch.empty((1,), dtype=torch.int32, device=dev))
                self._middles = {}
            idx, f, pid, hit, total = self._base
            col = lambda k, w=1: f[k * cap:(k + w) * cap]
            views = (idx[:cap], col(0, 3).view(cap, 3), col(3, 3).view(cap, 3),
                     (col(6), col(7), col(8), pid[:cap], hit[:cap]), total)
            self._middles[cap] = views
        return views

    def compact(self, w: Segment):
        """Launch ``compact`` on ``w``'s gated rays at the scene's
        compaction (``bezier.compact_lanes``) and return :meth:`middle`'s
        outputs, or None where every ray is solved.  The gated count goes
        to the open pass tally's slot, if any."""
        org, dir = w.rays
        R = org.shape[0]
        cap = compact_lanes(R, self.scene.bezier_compact_frac)
        if cap >= R:
            return None
        out = self.middle(cap)
        idx, org_c, dir_c, _, total = out
        slot = bezier_count_slot(cap, org.device)
        COMPACT.launch(org.device, R, cap, *[pointer(x) for x in (
            w.gate, w.gated, org, dir, idx, org_c, dir_c, total if slot is None else slot)])
        return out

    def solve(self, w: Segment, newton_fn=None):
        """The winner-contract solve of ``w``'s rays that pass its gate, as
        ``bezier.solve_gated`` returns it, with ``newton_fn`` or the
        scene's default solver: (idx, directions, (t, u, v, patch, hit)).
        The rays are compacted by :meth:`compact`; the Newton kernel
        (``newton_kernel.make_newton``) writes into the middle's buffers.
        The solver is called as it is: no gradient reaches a walk that has
        tables (:func:`kernel_tables`), so ``bezier.winner_root``'s
        backward would never run."""
        s = self.scene
        solver = default_solver(newton_fn, s.newton_iters, s.newton_restarts)
        out = self.compact(w)
        if out is None:
            return None, w.rays[1], solver(*w.rays, self.ctrl)
        idx, org_c, dir_c, hits, _ = out
        if isinstance(solver, partial) and solver.func is newton_kernel.solve:
            return idx, dir_c, solver(org_c, dir_c, self.ctrl, out=hits)
        return idx, dir_c, solver(org_c, dir_c, self.ctrl)

    def run(self, w: Segment, newton_fn=None):
        """Launch one segment on ``w``: its first kernel, with a Bezier
        object the solve (:meth:`solve`) and its row kernel, then its shade;
        return ``w.out``, the segment's output as its plain twin returns
        it.  Nothing here reads the card's results on the host."""
        first, rows, shade = w.KERNELS
        w.launch(first)
        if self.ctrl is not None:
            idx, d_c, hits = self.solve(w, newton_fn)
            bezier_rows(w.rows, idx, d_c, *hits, self.ctrl, kernel=rows)
        w.launch(shade)
        return w.out


class Segment:
    """The tensors of one segment and the lanes struct that points at them,
    which :meth:`WalkScene.run` launches on.  ``KERNELS``: the first kernel,
    the Bezier row kernel's handle and the shade kernel; a subclass sets
    ``rays`` (the rays the Bezier solve takes), ``struct`` and ``out``.
    Each launch writes only its outputs, so any may run again."""

    KERNELS: tuple

    def __init__(self, tables: WalkScene, want) -> None:
        """Check every (tensor, dtype, shape) of ``want`` against the first's
        device, then make the Bezier gate and rows and take the tables'
        buffer for the gated lanes a block (None without a Bezier
        object)."""
        self.tables = tables
        self.dev = dev = want[0][0].device
        N = want[0][0].shape[0]
        for x, dtype, shape in want:
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"{type(self).__name__} input {tuple(x.shape)} {x.dtype} on {x.device}, "
                                 f"expected {shape} {dtype} on {dev}")
        bez = tables.ctrl is not None
        self.gate = torch.empty((N,), dtype=torch.bool, device=dev) if bez else None
        self.rows = torch.empty((N, 7), dtype=torch.float32, device=dev) if bez else None
        self.gated = tables.gated_counts(N) if bez else None

    def launch(self, kernel: CudaKernel) -> None:
        kernel.launch(self.dev, ctypes.addressof(self.tables.struct),
                      ctypes.addressof(self.struct))


class SegmentLanes(Segment):
    """One photon-walk segment (``render/photon.regen_segment``): the
    carry, the segment's five draws and the ``WalkLanes`` struct."""

    KERNELS = (REFILL, BEZIER, SHADE)

    def __init__(self, tables: WalkScene, draws: tuple, carry, segs: int,
                 debias_roulette: bool):
        o, d, f, alive, depth, rr_off, emitted = c_in = [x.contiguous() for x in carry]
        N = o.shape[0]
        L = tables.n_lights
        draws = [x.contiguous() for x in draws]
        super().__init__(tables, [
            (o, torch.float32, (N, 3)), (d, torch.float32, (N, 3)), (f, torch.float32, (N, 3)),
            (alive, torch.bool, (N,)), (depth, torch.int32, (N,)), (rr_off, torch.int32, ()),
            (emitted, torch.float32, (L,))] + [(x, torch.float32, (N,)) for x in draws])
        dev = self.dev
        blocks = -(-N // THREADS)
        lid = None
        if L > 1:
            rank = torch.cumsum((~alive).to(torch.int32), 0) - 1
            lid = ((rr_off + torch.clamp_min(rank, 0)) % L).contiguous()
        v3 = lambda: torch.empty((N, 3), dtype=torch.float32, device=dev)
        one = lambda dtype, shape=(N,): torch.empty(shape, dtype=dtype, device=dev)
        o_r, d_r, f_r = v3(), v3(), v3()
        self.rays = (o_r, d_r)
        pos, nrm, nd, nf = v3(), v3(), v3(), v3()
        valid, alive_out, depth_out = one(torch.bool), one(torch.bool), one(torch.int32)
        rr_off_out, emitted_out = one(torch.int32, ()), one(torch.float32, (L,))
        t_a, obj_a, ins_a = one(torch.float32), one(torch.int32), one(torch.bool)
        partial_ = one(torch.int32, (blocks,))
        self._keep = (c_in, lid, draws, t_a, obj_a, ins_a, partial_)
        self.struct = _Lanes(*[pointer(x) for x in c_in], pointer(lid),
                             *[pointer(x) for x in draws],
                             *[pointer(x) for x in (o_r, d_r, f_r, t_a, obj_a, ins_a, self.gate,
                                                    self.rows, partial_, self.gated, pos, nrm,
                                                    valid, nd, nf, alive_out, depth_out,
                                                    rr_off_out, emitted_out)],
                             N, segs, int(debias_roulette), blocks)
        self.out = ((pos, nd, nf, alive_out, depth_out, rr_off_out, emitted_out),
                    (pos, nrm, f_r, valid))


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
    kernel.launch(dev, cap, rows.shape[0], pointer(idx), *[pointer(x) for x in a], pointer(rows))
