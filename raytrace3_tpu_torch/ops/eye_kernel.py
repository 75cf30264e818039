"""One segment of the staged eye as hand-written CUDA kernels.

``csrc/eye.cu`` holds two kernels that run one segment of
``render/eye.eye_segment`` at one slot a pixel: ``hit`` (the nearest plane
and sphere hit, the Bezier box gate and each block's count of gated lanes)
and ``shade`` (merge, the hit-point row, the next lane, the count of
continuations dropped).  The scene's tables, the rule that picks the
kernels and the Bezier middle between the two (``csrc/walk.cu``'s
compaction, Newton and ``csrc/walk.cu``'s row kernel) are the photon
walk's (``ops/walk_kernel.py``: ``kernel_tables``, ``WalkScene.run``);
:class:`SegmentLanes` holds the eye's lanes.  The plain twin is the op code
of ``render/eye.py`` (``eye_segment_plain``).  The kernels replace no TPU
kernel (see the source note).
"""

from __future__ import annotations

import ctypes

import torch

from . import walk_kernel
from .cuda_build import CudaKernel
from .walk_kernel import pointer

#: csrc/eye.cu's threads a block (kThreads).
THREADS = 256


class _Lanes(ctypes.Structure):
    """csrc/eye.cu's ``EyeLanes``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "o", "d", "wgt", "px", "act", "t_a", "obj_a", "ins_a", "gate", "rows", "gated", "out",
        "pos", "nd", "nw", "nv", "dropped")] + [("n", ctypes.c_int)]


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


class SegmentLanes(walk_kernel.Segment):
    """One eye segment's lanes and the ``EyeLanes`` struct that points at
    them, which ``walk_kernel.WalkScene.run`` launches on.  ``hit`` writes
    ``t_a``, ``obj_a``, ``ins_a``, ``gate``, ``rows`` and ``gated`` (the
    last three with a Bezier object), which ``shade`` (and the compaction)
    read; ``hit`` zeroes the count that ``shade`` adds to."""

    KERNELS = (HIT, BEZIER, SHADE)

    def __init__(self, tables: walk_kernel.WalkScene, lanes):
        o, d, wgt, px, act = (x.contiguous() for x in lanes)
        N = o.shape[0]
        super().__init__(tables, [
            (o, torch.float32, (N, 3)), (d, torch.float32, (N, 3)), (wgt, torch.float32, (N, 3)),
            (px, torch.int32, (N,)), (act, torch.bool, (N,))])
        one = lambda dtype, shape=(N,): torch.empty(shape, dtype=dtype, device=self.dev)
        self.rays = (o, d)
        self.t_a, self.obj_a, self.ins_a = one(torch.float32), one(torch.int32), one(torch.bool)
        out, pos, nd, nw = (one(torch.float32, s) for s in ((N, 11), (N, 3), (N, 3), (N, 3)))
        nv, dropped = one(torch.bool), one(torch.int32, ())
        self._keep = (wgt, px, act)
        self.struct = _Lanes(*[pointer(x) for x in (o, d, wgt, px, act, self.t_a, self.obj_a,
                                                    self.ins_a, self.gate, self.rows, self.gated,
                                                    out, pos, nd, nw, nv, dropped)], N)
        self.out = ((pos, nd, nw, lanes[3], nv), dropped, out)
