"""One segment of the staged eye as hand-written CUDA kernels.

``csrc/eye.cu`` holds two kernels that run one segment of
``render/eye.eye_segment`` at one slot a pixel around the Bezier compaction
and the Newton kernel, which stay as they are (``geometry/bezier.solve_gated``),
and the winners' rows, which ``csrc/walk.cu``'s ``bezier`` kernel writes as
in the photon walk: ``hit`` (the nearest plane and sphere hit, the Bezier
box gate) and ``shade`` (merge, the hit-point row, the next lane, the count
of continuations dropped).  :class:`EyeScene` holds the scene's side, built
once an eye pass; its ``segment`` is the CUDA path; its plain twin is the op
code of ``render/eye.py`` (``eye_segment_plain``), which ``eye_segment``
runs on CPU tensors, at more than one slot a pixel and under autograd.  The
kernels replace no TPU kernel (see the source note).
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from ..geometry.bezier import solve_gated, solve_winner
from . import walk_kernel
from .cuda_build import CudaKernel
from .walk_kernel import _p

#: csrc/eye.cu's threads a block (kThreads).
THREADS = 256


class _Lanes(ctypes.Structure):
    """csrc/eye.cu's ``EyeLanes``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "o", "d", "wgt", "px", "act", "t_a", "obj_a", "ins_a", "gate", "rows", "out", "pos",
        "nd", "nw", "nv", "dropped")] + [("n", ctypes.c_int)]


HIT = CudaKernel("eye.cu", "rt3_eye_hit", [ctypes.c_void_p, ctypes.c_void_p], name="eye_hit")
#: walk.cu's winner-row kernel, counted apart from the walk's launches.
BEZIER = CudaKernel("walk.cu", "rt3_walk_bezier", walk_kernel.BEZIER.argtypes,
                    name="eye_bezier")
SHADE = CudaKernel("eye.cu", "rt3_eye_shade", [ctypes.c_void_p, ctypes.c_void_p],
                   name="eye_shade")


def eye_segment_bytes(n: int) -> int:
    """The least bytes a segment of ``n`` lanes moves, each input read and
    each output written once: the lanes in (origin, direction and weight,
    36; pixel, 4; active, 1), the next lanes (position, direction and
    weight, 36; active, 1; the pixel is the input's) and the hit-point rows
    (44).  The scene's tables stay in L1/L2 and count nothing, as in
    ``walk_kernel.segment_bytes``."""
    return n * (41 + 37 + 44)


def eye_kernel_bytes(n: int, rays: int, solved: int) -> dict:
    """The bytes each kernel reads and writes at least, as the segment is
    split (with the Bezier object; the scene's tables count nothing):
    ``hit`` reads the origin and direction (24 a lane) and writes the
    analytic hit (t, object, inside), the gate and the Bezier row (38);
    ``bezier`` as ``walk_kernel.kernel_bytes``; ``shade`` reads the lanes,
    the analytic hit, the gate and the row (79) and writes the hit-point
    row and the next lanes (81)."""
    return {"eye_hit": n * (24 + 38),
            "eye_bezier": walk_kernel.kernel_bytes(0, rays, solved)["walk_bezier"],
            "eye_shade": n * (79 + 81)}


class EyeScene:
    """The scene's side of the kernels, built once an eye pass: the walk's
    tables (``walk_kernel.WalkScene``) with the eye's (objects, 13) material
    ``table`` of ``eye._eye_material_lanes``.  ``segments`` counts the
    segments run through the kernels."""

    def __init__(self, scene, table: torch.Tensor):
        self.scene = scene
        self.tables = walk_kernel.WalkScene(scene, table, scene.light_pos, scene.light_color)
        self.segments = 0

    def segment(self, lanes, newton_fn=None):
        """``render/eye.eye_segment`` at one slot a pixel on CUDA tensors:
        (next lanes, continuations dropped, hit-point rows (w, 11)).
        Nothing here reads the card's results on the host."""
        w = SegmentLanes(self, lanes)
        w.hit()
        ctrl = self.tables.ctrl
        if ctrl is not None:
            scene = self.scene
            solver = newton_fn if newton_fn is not None else partial(
                solve_winner, iters=scene.newton_iters, restarts=scene.newton_restarts)
            idx, d_c, hits = solve_gated(w.o, w.d, scene.bezier.ctrl, w.gate, solver,
                                         scene.bezier_compact_frac)
            walk_kernel.bezier_rows(w.rows, idx, d_c, *hits, ctrl, kernel=BEZIER)
        w.shade()
        self.segments += 1
        return w.out


class SegmentLanes:
    """The tensors of one eye segment and the ``EyeLanes`` struct that
    points at them; :meth:`hit` and :meth:`shade` launch the kernels on
    them (``hit`` zeroes the count that ``shade`` adds to).  ``hit`` writes
    ``t_a``, ``obj_a``, ``ins_a``, ``gate`` and ``rows`` (the last two with
    a Bezier object), which ``shade`` reads."""

    def __init__(self, es: EyeScene, lanes):
        o, d, wgt, px, act = (x.contiguous() for x in lanes)
        self.dev = dev = o.device
        N = o.shape[0]
        _check(dev, (o, d, wgt, px, act), N)
        v3 = lambda: torch.empty((N, 3), dtype=torch.float32, device=dev)
        one = lambda dtype, shape=(N,): torch.empty(shape, dtype=dtype, device=dev)
        bez = es.tables.ctrl is not None
        self.o, self.d = o, d
        self.gate = one(torch.bool) if bez else None
        self.rows = one(torch.float32, (N, 7)) if bez else None
        self.t_a, self.obj_a, self.ins_a = one(torch.float32), one(torch.int32), one(torch.bool)
        out, pos, nd, nw = one(torch.float32, (N, 11)), v3(), v3(), v3()
        nv, dropped = one(torch.bool), one(torch.int32, ())
        self.es = es
        self._keep = (wgt, px, act)
        self.struct = _Lanes(*[_p(x) for x in (o, d, wgt, px, act, self.t_a, self.obj_a,
                                               self.ins_a, self.gate, self.rows, out, pos, nd,
                                               nw, nv, dropped)], N)
        self.out = ((pos, nd, nw, lanes[3], nv), dropped, out)

    def hit(self) -> None:
        HIT.launch(self.dev, ctypes.addressof(self.es.tables.struct),
                   ctypes.addressof(self.struct))

    def shade(self) -> None:
        SHADE.launch(self.dev, ctypes.addressof(self.es.tables.struct),
                     ctypes.addressof(self.struct))


def _check(dev, lanes, N: int) -> None:
    o, d, wgt, px, act = lanes
    want = [(o, torch.float32, (N, 3)), (d, torch.float32, (N, 3)),
            (wgt, torch.float32, (N, 3)), (px, torch.int32, (N,)), (act, torch.bool, (N,))]
    for x, dtype, shape in want:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"eye kernel input {tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"expected {shape} {dtype} on {dev}")
