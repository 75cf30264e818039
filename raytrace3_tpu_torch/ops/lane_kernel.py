"""Lane-granular banded photon deposit and its transpose: the host side,
the CUDA kernels and their twins.

Port of ``raytrace3_tpu/ops/deposit_pallas.py``'s ``PallasDepositLane``,
the deposit of the gradient path (``diff.train.default_deposit_vjp``):

  * the banding, layout and windows of ``deposit_kernel.DepositTile``, with
    2-D (x, z) buckets by default and, with ``merge_z``, the 3 x 3
    neighbourhood collapsed into K = 3 key-contiguous windows (lower
    offset (dx, kz - 1), upper (dx, kz + 1));
  * the tiles' lane intervals flattened into at most ``work_cap`` work
    items of one ``chunk`` of lanes each (``_build_items``); items beyond
    the cap are dropped and counted as ``overflow`` (an upper bound on the
    candidate lanes skipped);
  * ``deposit_lane`` (kernel #3, ``csrc/deposit_lane.cu``) sums count and
    flux per hit slot over each tile's run of items;
  * with ``differentiable=True`` a call is a ``torch.autograd.Function``
    whose backward runs ``deposit_lane_bwd`` (kernel #4,
    ``csrc/deposit_lane_bwd.cu``), the transposed pair sum
    d_flux[j] = sum_i m_ij u_i over items re-cut at chunk alignment and
    sorted by deposit chunk; gradients reach ``hp.wgt`` and ``dep.flux``
    only (the box kernel's derivative is zero almost everywhere).

``DepositStream`` (``PallasDepositStream``) keeps this work list but hands
each tile its run of items with the fetch ``f`` and the lane mask packed as
``((wa - f) << 16) | (wb - f)``, for ``deposit_stream`` (kernel #6,
``csrc/deposit_stream.cu``).

CUDA tensors launch the kernels (or raise); CPU tensors take
:func:`deposit_lane_plain`, :func:`deposit_lane_bwd_plain` and
:func:`deposit_stream_plain`, nothing else.  Sorts are stable; JAX's
leaves the order of equal keys open, which moves only the order of flux
sums.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..core.types import Deposits, HitPoints
from .cuda_build import CudaKernel, check, ptr
from .deposit_kernel import (_GEOMETRY_ARGS, DepositTile, HpLayout, _geometry_args,
                             deposit_geometry, interval_pairs, intervals_plain)

FORWARD = CudaKernel("deposit_lane.cu", "rt3_deposit_lane", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # item_lo, item_hi, n_tiles, tile
    ctypes.c_void_p, ctypes.c_void_p,                               # wa, wb
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,            # packed, dep, Dp
    ctypes.c_void_p,                                                # out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,      # threads, splits, smem, scratch
    ctypes.c_void_p, ctypes.c_void_p,                               # part_run, part_end
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # n_parts, n_items, per_block
], name="deposit_lane")
BACKWARD = CudaKernel("deposit_lane_bwd.cu", "rt3_deposit_lane_bwd", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # run_lo, run_hi, n_blocks, chunk
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # wt, wa, wb, tile
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,              # packed, u, dep
    ctypes.c_longlong, ctypes.c_void_p,                             # Dp, out
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,                    # threads, smem, scratch
    ctypes.c_void_p, ctypes.c_void_p,                               # part_run, part_end
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # n_parts, n_items, per_block
], name="deposit_lane_bwd")
STREAM = CudaKernel("deposit_stream.cu", "rt3_deposit_stream", [
    ctypes.c_void_p, ctypes.c_void_p,                               # itf, itab
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # starts, ends, n_tiles, tile
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,            # packed, dep, Dp
    ctypes.c_void_p,                                                # out
    *_GEOMETRY_ARGS,
], name="deposit_stream")
#: The stream items' 16-bit mask fields hold offsets up to 2 chunks.
MAX_STREAM_CHUNK = 0x7FFF
#: the forward's fetch alignment on the TPU (the DMA's lane granule): item
#: boundaries, and so work-item counts and overflow, follow it
FETCH_ALIGN = 128
#: Kernels #3 and #4 run one block a part of a run of work items (a tile's
#: for #3, a deposit chunk's for #4): a part holds at most this many items
#: (``run_parts``).  On the train round a tile has 1.9 items and a chunk 8.8
#: on average, the heaviest 28 and 276; 3 was the fastest of 2-5 for #3 and
#: of 2-8 for #4 there (PERF.md section 6).
LANE_ITEMS_PER_BLOCK = 3
LANE_BWD_ITEMS_PER_BLOCK = 3
#: Kernel #3's grid splits (deposit_stage.cuh): one, as its blocks follow
#: the parts of each tile's run instead.
LANE_GRID_SPLITS = 1
#: csrc/deposit_lane_bwd.cu's compiled constants: the largest tile, chunk
#: and block (kBwdMaxTile, kBwdMaxChunk, kBwdMaxThreads), the most items a
#: part (kBwdMaxItems), a block's shared memory on an H100 with the opt-in
#: (kBwdMaxSharedBytes) and the most slot groups (kBwdMaxGroups).  The
#: kernel refuses a geometry that does not fit them; a CPU test reads them
#: back from the source.
LANE_BWD_MAX_TILE = 1024
LANE_BWD_MAX_CHUNK = 1024
LANE_BWD_MAX_THREADS = 1024
LANE_BWD_MAX_ITEMS = 8
LANE_BWD_MAX_SHARED_BYTES = 232448
LANE_BWD_MAX_GROUPS = 16


def parts_bound(n_runs: int, per_block: int, n_items: int) -> int:
    """The most parts runs of a work list of ``n_items`` can have: the
    launch's block count, which needs no count from the device."""
    return n_runs + -(-n_items // per_block)


def run_parts(lo: torch.Tensor, hi: torch.Tensor, per_block: int, n_items: int):
    """(part_run, part_end), int32: runs [lo_r, hi_r) of a work list of
    ``n_items`` cut into parts of at most ``per_block`` items, an empty run
    one part.  ``part_end[r]`` counts the parts through run r;
    ``part_run[j]`` is part j's run, for ``parts_bound`` parts, the spare
    ones marked ``len(lo)``.  The plain version of the kernels' plan
    (``csrc/deposit_stage.cuh: plan_parts``)."""
    n = torch.clamp_min(hi - lo, 0)
    parts = torch.clamp_min(torch.div(n + per_block - 1, per_block, rounding_mode="floor"), 1)
    part_end = torch.cumsum(parts, 0, dtype=torch.int32)
    j = torch.arange(parts_bound(lo.shape[0], per_block, n_items), dtype=torch.int32,
                     device=lo.device)
    return torch.searchsorted(part_end, j, right=True, out_int32=True), part_end


@dataclass(frozen=True)
class LaneBwdGeometry:
    """Launch geometry of kernel #4 (csrc/deposit_lane_bwd.cu): ``threads``
    = the chunk rounded up to a warp, one block a part of at most
    ``items_per_block`` items of a chunk's run (``run_parts``), and
    ``shared_bytes`` of dynamic shared memory for the part's tiles, the
    partial sums (``partial_stride`` each of 3) and the chunk's deposit
    lanes."""

    tile: int
    chunk: int
    items_per_block: int
    threads: int
    partial_stride: int
    shared_bytes: int

    def groups(self, lanes: int) -> int:
        """Slot groups the kernel makes for a part of ``lanes`` masked
        lanes in all: virtual thread g lanes + q tests lane q against rows
        g, g + groups, ..."""
        if lanes <= 0:
            return 0
        return max(1, min(self.threads // lanes, self.tile, LANE_BWD_MAX_GROUPS))


def lane_bwd_geometry(tile: int, chunk: int) -> LaneBwdGeometry:
    """The geometry of kernel #4 for ``tile`` (1..1024) hit slots and
    ``chunk`` (1..1024) deposit lanes a chunk, in parts of at most
    ``LANE_BWD_ITEMS_PER_BLOCK`` items."""
    k = LANE_BWD_ITEMS_PER_BLOCK
    if not 1 <= tile <= LANE_BWD_MAX_TILE or not 1 <= chunk <= LANE_BWD_MAX_CHUNK:
        raise ValueError(f"tile {tile} or chunk {chunk} is not in 1..1024")
    threads = -(-chunk // 32) * 32
    stride = max(threads, k * chunk)
    smem = 4 * (k * (tile * 8 + -(-tile * 3 // 4) * 4) + 3 * stride + 6 * chunk)
    return LaneBwdGeometry(tile, chunk, k, threads, stride, smem)


def _runs_items(lo: torch.Tensor, hi: torch.Tensor):
    """(owner (P,), item (P,)) for every item of the runs [lo_k, hi_k)."""
    lens = torch.clamp_min(hi.long() - lo.long(), 0)
    owner = torch.repeat_interleave(torch.arange(lo.shape[0], device=lo.device), lens)
    first = torch.cumsum(lens, 0) - lens
    item = lo.long()[owner] + torch.arange(owner.shape[0], device=lo.device) - first[owner]
    return owner, item


def deposit_lane_plain(item_lo: torch.Tensor, item_hi: torch.Tensor, wa: torch.Tensor,
                       wb: torch.Tensor, packed: torch.Tensor, dep_packed: torch.Tensor,
                       pairs_per_step: int = 1 << 22,
                       sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel #3's contract in plain PyTorch: count (col 0) and raw RGB flux
    (cols 1:4) per hit slot of tile i over lanes [wa, wb) of its items
    [item_lo[i], item_hi[i]); tiles with an empty run read 0.  Steps of
    ``pairs_per_step`` pair tests keep a full round in memory.
    ``sum_dtype``: see ``deposit_kernel.intervals_plain``."""
    tile_of, item = _runs_items(item_lo, item_hi)
    return intervals_plain(tile_of, wa.long()[item], wb.long()[item], packed,
                           dep_packed, item_lo.shape[0], pairs_per_step, sum_dtype)


def deposit_lane_bwd_plain(run_lo: torch.Tensor, run_hi: torch.Tensor, wt: torch.Tensor,
                           wa: torch.Tensor, wb: torch.Tensor, packed: torch.Tensor,
                           u: torch.Tensor, dep_packed: torch.Tensor, tile: int,
                           pairs_per_step: int = 1 << 22,
                           sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel #4's contract in plain PyTorch: (3, Dp) d_flux per sorted
    deposit lane, the sum over the items of its chunk's run [run_lo,
    run_hi) of u_i over the pairs (hit slot i of tile ``wt``, lane in
    [wa, wb)) taken; chunks with an empty run read 0.  The sums are taken
    in ``sum_dtype`` (float64: each lane's sum rounded to float32 once, the
    witness the kernel is held to)."""
    n_tiles = packed.shape[0] // tile
    _, item = _runs_items(run_lo, run_hi)
    uu = u.reshape(n_tiles, tile, 3).to(sum_dtype)
    out = torch.zeros((dep_packed.shape[1], 3), dtype=sum_dtype, device=packed.device)
    for tl, lane, _, m in interval_pairs(wt.long()[item], wa.long()[item],
                                         wb.long()[item], packed.reshape(n_tiles, tile, 8),
                                         dep_packed, pairs_per_step):
        out.index_add_(0, lane, (m.to(sum_dtype)[:, :, None] * uu[tl]).sum(1))
    return out.T.to(torch.float32).contiguous()


def _check_layout(packed, dep_packed, tile, dev):
    c_pad = packed.shape[0]
    check("packed", packed, torch.float32, (c_pad, 8), dev)
    check("dep_packed", dep_packed, torch.float32, (16, None), dev)
    if not 1 <= tile <= 1024 or c_pad % tile:
        raise ValueError(f"c_pad {c_pad} is not a whole number of tiles of "
                         f"{tile} (1..1024) slots")
    return c_pad // tile


def _deposit_lane_cuda(item_lo, item_hi, wa, wb, packed, dep_packed):
    dev = packed.device
    n_tiles = item_lo.shape[0]
    W = wa.shape[0]
    check("item_lo", item_lo, torch.int32, (n_tiles,), dev)
    check("item_hi", item_hi, torch.int32, (n_tiles,), dev)
    check("wa", wa, torch.int32, (W,), dev)
    check("wb", wb, torch.int32, (W,), dev)
    if n_tiles < 1 or packed.shape[0] % n_tiles:
        raise ValueError(f"{packed.shape[0]} hit slots are not {n_tiles} tiles")
    tile = packed.shape[0] // n_tiles
    _check_layout(packed, dep_packed, tile, dev)
    out = torch.empty((packed.shape[0], 8), dtype=torch.float32, device=dev)
    launch_lane(FORWARD, out, item_lo, item_hi, wa, wb, packed, dep_packed)
    return out


def launch_lane(kernel, out, item_lo, item_hi, wa, wb, packed, dep_packed):
    """Kernel #3's entry point (``kernel``) into ``out`` with its launch
    geometry, one block a part of ``LANE_ITEMS_PER_BLOCK`` items."""
    per_block = LANE_ITEMS_PER_BLOCK
    n_tiles, tile, dev = item_lo.shape[0], packed.shape[0] // item_lo.shape[0], out.device
    geom = deposit_geometry(tile, LANE_GRID_SPLITS)
    n_parts = parts_bound(n_tiles, per_block, wa.shape[0])
    scratch = torch.empty((n_parts, tile, 4), dtype=torch.float32, device=dev)
    plan = torch.empty((n_parts + n_tiles,), dtype=torch.int32, device=dev)
    kernel.launch(dev, ptr(item_lo), ptr(item_hi), n_tiles, tile, ptr(wa), ptr(wb),
                  ptr(packed), ptr(dep_packed), dep_packed.shape[1], ptr(out), geom.threads,
                  geom.splits, geom.shared_bytes, ptr(scratch), ptr(plan),
                  ptr(plan[n_parts:]), n_parts, wa.shape[0], per_block)
    del scratch, plan   # the stream orders their reuse after the kernel


def deposit_lane(item_lo: torch.Tensor, item_hi: torch.Tensor, wa: torch.Tensor,
                 wb: torch.Tensor, packed: torch.Tensor,
                 dep_packed: torch.Tensor) -> torch.Tensor:
    """Count (col 0) and raw RGB flux (cols 1:4) per hit slot, (c_pad, 8).

    ``item_lo``, ``item_hi``: (n_tiles,) int32 runs of work items per tile;
    ``wa``, ``wb``: (W,) int32 lane masks; ``packed``: (c_pad, 8) hit slots;
    ``dep_packed``: (16, Dp) sorted deposits.  CUDA tensors launch kernel #3
    (or raise); CPU tensors take :func:`deposit_lane_plain`.
    """
    if packed.is_cuda:
        return _deposit_lane_cuda(item_lo, item_hi, wa, wb, packed, dep_packed)
    if packed.device.type == "cpu":
        return deposit_lane_plain(item_lo, item_hi, wa, wb, packed, dep_packed)
    raise ValueError(f"no lane deposit kernel for device {packed.device}")


def _deposit_lane_bwd_cuda(run_lo, run_hi, wt, wa, wb, packed, u, dep_packed,
                           tile, chunk):
    dev = packed.device
    n_blocks = run_lo.shape[0]
    W = wt.shape[0]
    check("run_lo", run_lo, torch.int32, (n_blocks,), dev)
    check("run_hi", run_hi, torch.int32, (n_blocks,), dev)
    for name, x in (("wt", wt), ("wa", wa), ("wb", wb)):
        check(name, x, torch.int32, (W,), dev)
    _check_layout(packed, dep_packed, tile, dev)
    check("u", u, torch.float32, (packed.shape[0], 3), dev)
    Dp = dep_packed.shape[1]
    if not 1 <= chunk <= 1024 or Dp != n_blocks * chunk:
        raise ValueError(f"Dp {Dp} is not {n_blocks} chunks of {chunk} (1..1024) lanes")
    out = torch.empty((3, Dp), dtype=torch.float32, device=dev)
    if n_blocks:
        launch_lane_bwd(BACKWARD, out, run_lo, run_hi, wt, wa, wb, packed, u, dep_packed,
                        tile, chunk)
    return out


def launch_lane_bwd(kernel, out, run_lo, run_hi, wt, wa, wb, packed, u, dep_packed,
                    tile: int, chunk: int):
    """Kernel #4's entry point (``kernel``) into ``out`` with its launch
    geometry, one block a part of ``LANE_BWD_ITEMS_PER_BLOCK`` items."""
    dev, n_blocks, Dp = out.device, run_lo.shape[0], out.shape[1]
    geom = lane_bwd_geometry(tile, chunk)
    per_block = geom.items_per_block
    n_parts = parts_bound(n_blocks, per_block, wt.shape[0])
    scratch = torch.empty((n_parts, 3, chunk), dtype=torch.float32, device=dev)
    plan = torch.empty((n_parts + n_blocks,), dtype=torch.int32, device=dev)
    kernel.launch(dev, ptr(run_lo), ptr(run_hi), n_blocks, chunk, ptr(wt), ptr(wa), ptr(wb),
                  tile, ptr(packed), ptr(u), ptr(dep_packed), Dp, ptr(out), geom.threads,
                  geom.shared_bytes, ptr(scratch), ptr(plan), ptr(plan[n_parts:]), n_parts,
                  wt.shape[0], per_block)
    del scratch, plan   # the stream orders their reuse after the kernel


def deposit_lane_bwd(run_lo: torch.Tensor, run_hi: torch.Tensor, wt: torch.Tensor,
                     wa: torch.Tensor, wb: torch.Tensor, packed: torch.Tensor,
                     u: torch.Tensor, dep_packed: torch.Tensor, tile: int,
                     chunk: int) -> torch.Tensor:
    """(3, Dp) d_flux per sorted deposit lane: the transpose of
    :func:`deposit_lane` over chunk-sorted items.

    ``run_lo``, ``run_hi``: (Dp / chunk,) int32 runs of items per deposit
    chunk; ``wt``, ``wa``, ``wb``: (W',) int32 item tile and lane mask;
    ``u``: (c_pad, 3) cotangent rows.  CUDA tensors launch kernel #4 (or
    raise); CPU tensors take :func:`deposit_lane_bwd_plain`.
    """
    if packed.is_cuda:
        return _deposit_lane_bwd_cuda(run_lo, run_hi, wt, wa, wb, packed, u,
                                      dep_packed, tile, chunk)
    if packed.device.type == "cpu":
        return deposit_lane_bwd_plain(run_lo, run_hi, wt, wa, wb, packed, u,
                                      dep_packed, tile)
    raise ValueError(f"no lane deposit kernel for device {packed.device}")


def stream_mask(itf: torch.Tensor, itab: torch.Tensor):
    """The lane interval [wa, wb) of each stream item: its fetch ``itf``
    plus the two 16-bit offsets packed in ``itab``."""
    f = itf.long()
    return f + (itab.long() >> 16), f + (itab.long() & 0xFFFF)


def deposit_stream_plain(itf: torch.Tensor, itab: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor, packed: torch.Tensor,
                         dep_packed: torch.Tensor, pairs_per_step: int = 1 << 22,
                         sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel #6's contract in plain PyTorch: count (col 0) and raw RGB flux
    (cols 1:4) per hit slot of tile i over the decoded lanes [wa, wb) of its
    items [starts[i], ends[i]); tiles with an empty run read 0.
    ``sum_dtype``: see ``deposit_kernel.intervals_plain``."""
    wa, wb = stream_mask(itf, itab)
    tile_of, item = _runs_items(starts, ends)
    Dp = dep_packed.shape[1]
    return intervals_plain(tile_of, torch.clamp(wa[item], 0, Dp), torch.clamp(wb[item], 0, Dp),
                           packed, dep_packed, starts.shape[0], pairs_per_step, sum_dtype)


def _deposit_stream_cuda(itf, itab, starts, ends, packed, dep_packed):
    dev = packed.device
    n_tiles, W = starts.shape[0], itf.shape[0]
    check("itf", itf, torch.int32, (W,), dev)
    check("itab", itab, torch.int32, (W,), dev)
    check("starts", starts, torch.int32, (n_tiles,), dev)
    check("ends", ends, torch.int32, (n_tiles,), dev)
    if n_tiles < 1 or packed.shape[0] % n_tiles:
        raise ValueError(f"{packed.shape[0]} hit slots are not {n_tiles} tiles")
    tile = packed.shape[0] // n_tiles
    _check_layout(packed, dep_packed, tile, dev)
    out = torch.empty((packed.shape[0], 8), dtype=torch.float32, device=dev)
    gargs, scratch = _geometry_args(tile, packed.shape[0], dev)
    STREAM.launch(dev, ptr(itf), ptr(itab), ptr(starts), ptr(ends), n_tiles, tile,
                  ptr(packed), ptr(dep_packed), dep_packed.shape[1], ptr(out), *gargs)
    del scratch     # the stream orders its reuse after the kernel
    return out


def deposit_stream(itf: torch.Tensor, itab: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor, packed: torch.Tensor,
                   dep_packed: torch.Tensor) -> torch.Tensor:
    """Count (col 0) and raw RGB flux (cols 1:4) per hit slot, (c_pad, 8).

    ``itf``, ``itab``: (W,) int32 stream items (fetch, packed lane mask,
    :func:`stream_mask`); ``starts``, ``ends``: (n_tiles,) int32 runs of
    items per tile; ``packed``: (c_pad, 8) hit slots; ``dep_packed``:
    (16, Dp) sorted deposits.  CUDA tensors launch kernel #6 (or raise);
    CPU tensors take :func:`deposit_stream_plain`.
    """
    if packed.is_cuda:
        return _deposit_stream_cuda(itf, itab, starts, ends, packed, dep_packed)
    if packed.device.type == "cpu":
        return deposit_stream_plain(itf, itab, starts, ends, packed, dep_packed)
    raise ValueError(f"no stream deposit kernel for device {packed.device}")


class _LaneDeposit(torch.autograd.Function):
    """``DepositLane`` with gradients into ``hp.wgt`` and ``dep.flux``
    (JAX ``_lane_deposit_diff``): the forward keeps the flux row sums, the
    backward returns d_wgt = g_tao fl / pi and d_flux from kernel #4 with
    u = wgt g_tao / pi."""

    @staticmethod
    def forward(ctx, depo, hp, dep, prep, wgt, flux):
        hp, dep = hp.replace(wgt=wgt), dep.replace(flux=flux)
        cnt, d_tao, overflow, fl = depo._forward_full(hp, dep, prep)
        ctx.depo, ctx.hp, ctx.dep, ctx.prep = depo, hp, dep, prep
        ctx.save_for_backward(wgt, fl)
        ctx.mark_non_differentiable(cnt, overflow)
        return cnt, d_tao, overflow

    @staticmethod
    def backward(ctx, _g_cnt, g_tao, _g_overflow):
        wgt, fl = ctx.saved_tensors
        d_wgt = g_tao * fl / math.pi
        d_flux = None
        if ctx.needs_input_grad[5]:
            u = wgt * g_tao / math.pi
            d_flux = ctx.depo._backward_flux(ctx.hp, ctx.dep, ctx.prep, u)
        return None, None, None, None, d_wgt, d_flux


class DepositLane(DepositTile):
    """``deposit_fn(hp, dep) -> (d_nphot, d_tao, overflow)``, lane-granular.

    ``overflow`` bounds the candidate lanes dropped by ``work_cap`` (0 =
    exact); ``photon_rounds`` folds it into ``deposits_dropped``.  With
    ``differentiable=True`` calls go through the custom backward and
    ``photon_rounds`` keeps the hit-point-order path.
    """

    def __init__(self, tile: int = 256, chunk: int = 512, work_cap: int = 16384,
                 merge_z: bool = True, differentiable: bool = False, **kw):
        kw.setdefault("bucket2d", True)
        super().__init__(tile=tile, chunk=chunk, **kw)
        if chunk % FETCH_ALIGN:
            raise ValueError(f"chunk must be a multiple of {FETCH_ALIGN} lanes")
        self.work_cap = work_cap
        self.merge_z = merge_z and self.bucket2d
        self.differentiable = differentiable
        if self.merge_z:
            # One merged window per dx: lo at (dx, kz - 1) with the tile's
            # y_lo, hi at (dx, kz + 1) with its y_hi.
            self.win_offs = [dx * self.n_bz for dx in (-1, 0, 1)]
            self.win_offs_lo = [dx * self.n_bz - 1 for dx in (-1, 0, 1)]
            self.win_offs_hi = [dx * self.n_bz + 1 for dx in (-1, 0, 1)]

    def work_items(self, hp: HitPoints, dep: Deposits, prep: HpLayout | None = None):
        """The true work-item count of these inputs (for sizing ``work_cap``)."""
        if prep is None:
            prep = self.prepare(hp)
        n_tiles = self._c_pad(hp.capacity) // self.tile
        dkeys, _, _ = self._dep_sorted(dep, self.chunk)
        sk, ek = self._window_lanes(prep, dkeys, n_tiles)
        a0 = (sk // FETCH_ALIGN) * FETCH_ALIGN
        nch = torch.where(ek > sk, (ek - a0 + self.chunk - 1) // self.chunk, 0)
        return nch.sum()

    def _build_items(self, sk, ek, n_tiles: int, W: int, Dp: int, align: int):
        """Flatten the (tile, window) lane intervals into W work items.

        Chunks lie on an ``align``-aligned grid anchored at each window's
        start; an item's lane interval [wa, wb) is what it counts, so grid
        slop never double counts or misses a lane.  The forward uses
        ``FETCH_ALIGN``, the backward ``chunk`` (each item then lies in one
        deposit chunk).  Returns (wt, f, wa, wb, nc_tile, cum, total), the
        first four (W,) int32; pad items beyond ``total`` have wa = wb = 0
        and the last real item's tile and fetch.
        """
        ch = self.chunk
        K = sk.shape[1]
        sk, ek = sk.long(), ek.long()
        a0 = (sk // align) * align                              # (n_tiles, K)
        nch = torch.where(ek > sk, (ek - a0 + ch - 1) // ch, 0)
        nc_tile = nch.sum(1)                                    # (n_tiles,)
        cum = torch.cumsum(nc_tile, 0)
        total = cum[-1]
        s_idx = torch.arange(W, device=sk.device)
        wt = torch.clamp_max(torch.searchsorted(cum, s_idx, right=True), n_tiles - 1)
        j = s_idx - (cum[wt] - nc_tile[wt])                     # chunk within tile
        ncc_w = torch.cumsum(nch, 1)[wt]                        # (W, K)
        w_id = torch.clamp_max((j[:, None] >= ncc_w).sum(1), K - 1)
        prev = torch.gather(ncc_w, 1, torch.clamp_min(w_id - 1, 0)[:, None])[:, 0]
        jk = j - torch.where(w_id > 0, prev, 0)
        pick = lambda a: torch.gather(a[wt], 1, w_id[:, None])[:, 0]
        f = pick(a0) + jk * ch
        wa = torch.maximum(pick(sk), f)
        wb = torch.minimum(pick(ek), f + ch)
        # The TPU clamps the fetch into [0, Dp - ch]; the mask stays inside.
        f = torch.clamp(f, 0, Dp - ch)
        live = s_idx < total
        last = torch.clamp(total - 1, 0, W - 1)
        i32 = lambda x: x.to(torch.int32)
        return (i32(torch.where(live, wt, wt[last])), i32(torch.where(live, f, f[last])),
                i32(torch.where(live, wa, 0)), i32(torch.where(live, wb, 0)),
                nc_tile, cum, total)

    def __call__(self, hp: HitPoints, dep: Deposits, prep: HpLayout | None = None):
        if prep is None:
            prep = self.prepare(hp)
        if self.differentiable:
            return _LaneDeposit.apply(self, hp, dep, prep, hp.wgt, dep.flux)
        cnt, d_tao, overflow, _ = self._forward_full(hp, dep, prep)
        return cnt, d_tao, overflow

    def _forward_full(self, hp: HitPoints, dep: Deposits, prep: HpLayout):
        """(cnt, d_tao, overflow, raw flux row sums), in hit-point order."""
        packed = prep.packed.clone()
        packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
        cnt_pad, fl_pad, overflow = self._kernel_call(packed, dep, prep)
        cnt, fl = self.unpack_state(prep, cnt_pad, fl_pad)
        return cnt, hp.wgt * fl / math.pi, overflow, fl     # Raytracer.h:156

    def forward_items(self, sk, ek, n_tiles: int, Dp: int):
        """Kernel #3's work list: (item_lo, item_hi, wa, wb, overflow).

        Each tile runs its items below the cap: a tile whose items straddle
        W keeps its partial sums, one whose first item is at or beyond W (or
        that has none) reads 0.  ``overflow`` bounds the lanes dropped.
        """
        W = self.work_cap
        _, _, wa, wb, nc_tile, cum, total = self._build_items(
            sk, ek, n_tiles, W, Dp, FETCH_ALIGN)
        item_hi = torch.clamp_max(cum, W)
        item_lo = torch.minimum(cum - nc_tile, item_hi)
        overflow = (torch.clamp_min(total - W, 0) * self.chunk).to(torch.int32)
        return item_lo.to(torch.int32), item_hi.to(torch.int32), wa, wb, overflow

    def backward_items(self, sk, ek, n_tiles: int, Dp: int):
        """Kernel #4's work list: (run_lo, run_hi, wt, wa, wb).

        The forward's intervals cut at chunk alignment (at most one item
        more per window than the forward's, so the cap W' = work_cap + K
        n_tiles truncates only when the forward's did), sorted by deposit
        chunk (stably; pads last) so that each chunk's items form one run.
        """
        ch = self.chunk
        W = self.work_cap + len(self.win_offs) * n_tiles
        wt, f, wa, wb, _, _, _ = self._build_items(sk, ek, n_tiles, W, Dp, ch)
        block = torch.where(wa < wb, f // ch, Dp // ch)
        block, order = torch.sort(block, stable=True)
        blocks = torch.arange(Dp // ch, dtype=block.dtype, device=block.device)
        run_lo = torch.searchsorted(block, blocks).to(torch.int32)
        run_hi = torch.searchsorted(block, blocks, right=True).to(torch.int32)
        return (run_lo, run_hi, wt[order].contiguous(), wa[order].contiguous(),
                wb[order].contiguous())

    def _kernel_call(self, packed: torch.Tensor, dep: Deposits, prep: HpLayout):
        """(cnt_pad, flux_pad, overflow) in layout space, through kernel #3."""
        n_tiles = packed.shape[0] // self.tile
        dkeys, dep_packed, Dp = self._dep_sorted(dep, self.chunk)
        sk, ek = self._window_lanes(prep, dkeys, n_tiles)
        item_lo, item_hi, wa, wb, overflow = self.forward_items(sk, ek, n_tiles, Dp)
        out = deposit_lane(item_lo, item_hi, wa, wb, packed, dep_packed)
        return out[:, 0], out[:, 1:4], overflow

    def _backward_flux(self, hp: HitPoints, dep: Deposits, prep: HpLayout,
                       u: torch.Tensor) -> torch.Tensor:
        """Transposed banded product d_flux[j] = sum_i m_ij u_i, (D, 3),
        over the forward's layout and lane intervals (``backward_items``);
        the sorted lanes' sums are unsorted by the deposit order."""
        t, ch = self.tile, self.chunk
        c_pad = self._c_pad(hp.capacity)
        n_tiles = c_pad // t
        packed = prep.packed.clone()
        packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
        D = dep.pos.shape[0]
        dkeys, dep_packed, Dp, d_ord = self._dep_sorted(dep, ch, with_order=True)
        sk, ek = self._window_lanes(prep, dkeys, n_tiles)
        items = self.backward_items(sk, ek, n_tiles, Dp)
        u_packed = torch.zeros((c_pad, 3), dtype=torch.float32, device=u.device)
        u_packed[prep.g] = u.to(torch.float32)
        out = deposit_lane_bwd(*items, packed, u_packed, dep_packed, t, ch)
        d_flux = torch.zeros((D, 3), dtype=torch.float32, device=u.device)
        d_flux[d_ord] = out[:, :D].T
        return d_flux


class DepositStream(DepositLane):
    """``DepositLane``'s work list streamed per tile (``PallasDepositStream``):
    each tile walks its run of items, each item a 128-aligned fetch ``f``
    and a lane mask packed as ``((wa - f) << 16) | (wb - f)``, through
    kernel #6.  Items beyond ``work_cap`` are dropped and counted in
    ``overflow``, as in ``DepositLane``.  ``nbuf`` is the depth of the TPU
    kernel's DMA ring, kept for parity with ``PallasDepositStream``; the
    card's kernel does not read it: its ring's depth is
    ``csrc/deposit_stage.cuh``'s ``kRing`` (``deposit_kernel.RING``).
    """

    def __init__(self, *a, nbuf: int = 2, **kw):
        super().__init__(*a, **kw)
        if self.chunk > MAX_STREAM_CHUNK:
            raise ValueError(f"chunk {self.chunk} does not fit the items' 16-bit "
                             f"mask fields (at most {MAX_STREAM_CHUNK})")
        self.nbuf = nbuf

    def stream_items(self, sk, ek, n_tiles: int, Dp: int):
        """Kernel #6's work list (deposit_pallas.py:1200-1240): (itf, itab,
        starts, ends, overflow)."""
        ch, W = self.chunk, self.work_cap
        _, f, wa, wb, nc_tile, cum, total = self._build_items(sk, ek, n_tiles, W, Dp,
                                                              FETCH_ALIGN)
        itab = (torch.clamp(wa - f, 0, 2 * ch) << 16) | torch.clamp(wb - f, 0, 2 * ch)
        i32 = lambda x: x.to(torch.int32).contiguous()
        overflow = (torch.clamp_min(total - W, 0) * ch).to(torch.int32)
        return (i32(f), i32(itab), i32(torch.clamp_max(cum - nc_tile, W)),
                i32(torch.clamp_max(cum, W)), overflow)

    def _kernel_call(self, packed: torch.Tensor, dep: Deposits, prep: HpLayout):
        """(cnt_pad, flux_pad, overflow) in layout space, through kernel #6."""
        n_tiles = packed.shape[0] // self.tile
        dkeys, dep_packed, Dp = self._dep_sorted(dep, self.chunk)
        sk, ek = self._window_lanes(prep, dkeys, n_tiles)
        itf, itab, starts, ends, overflow = self.stream_items(sk, ek, n_tiles, Dp)
        out = deposit_stream(itf, itab, starts, ends, packed, dep_packed)
        return out[:, 0], out[:, 1:4], overflow
