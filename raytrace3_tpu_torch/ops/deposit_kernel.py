"""Banded photon deposit: the host sides, the CUDA tile and block kernels
and their twins.

Port of ``raytrace3_tpu/ops/deposit_pallas.py``'s ``PallasDepositTile``
host side, with 1-D banding (the bench's deposit, ``bucket2d=False``) or
2-D banding (``bucket2d=True``, which ``ops/lane_kernel.DepositLane``
builds on), and of the two backends built on the same layout:

  * ``DepositBlock`` (``PallasDeposit``, the CLI's ``--deposit pallas``):
    the windows widened to whole ``wchunk``-aligned deposit blocks, made
    disjoint at block granularity and flattened into a work list of at most
    ``work_cap`` (tile, block) items; ``deposit_block`` (kernel #5,
    ``csrc/deposit_block.cu``) sums each tile's items with no lane mask;
  * ``DepositZTile`` (``PallasDepositZTile``): coarse z buckets inside each
    x band, K = 6 windows per tile, over ``deposit_tile``.

The tile layout:

  * key = bucket id * y_stride + quantized y, with bucket width 2r along
    x (1-D) or along x and z (2-D, bucket id = kx * n_bz + kz) and y
    quantized to 1/8 unit; window bounds are floor/ceil, so every window
    is a superset and the pair test is the true filter;
  * hit points live in a bucket-aligned, tile-padded layout (``prepare``,
    once per pass), so each tile of ``tile`` slots belongs to one bucket and
    its neighbours lie in K key intervals of the round's sorted deposits
    (3 in 1-D, 9 in 2-D), found by ``searchsorted`` and made disjoint by a
    cascade;
  * ``deposit_tile(sk, ek, packed, dep_packed)`` walks those intervals:
    ``csrc/deposit_tile.cu`` for CUDA tensors, :func:`deposit_tile_plain`
    for CPU tensors, nothing else (and likewise ``deposit_block``).

Sorts are stable (``torch.sort(stable=True)``); the JAX side's sort leaves
the order of equal keys open, which moves only the flux summation order.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import Deposits, HitPoints, Record
from ..render.deposit import NORMAL_DOT_MIN
from .cuda_build import CudaKernel, check, ptr

#: Reference fixed search radius^2 = 2.0 (Raytracer.h:85).
SEARCH_R = math.sqrt(2.0)
DEFAULT_X_LO = -40.0
DEFAULT_X_HI = 200.0
DEFAULT_Z_LO = -40.0
DEFAULT_Z_HI = 200.0
#: Sentinel position for invalid and padding deposit lanes.
FAR = 1e9
#: Sort-key y quantisation: 1/8 unit over [y_lo, y_hi).
Y_LO = -40.0
Y_HI = 240.0
YQ = 8.0

#: The launch geometry's arguments, after ``out``: threads, splits,
#: gsplits, shared bytes, scratch.
_GEOMETRY_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
KERNEL = CudaKernel("deposit_tile.cu", "rt3_deposit_tile", [
    ctypes.c_void_p, ctypes.c_void_p,                    # sk, ek
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # n_tiles, K, tile
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # packed, dep, Dp
    ctypes.c_void_p,                                     # out
    *_GEOMETRY_ARGS,
], name="deposit_tile")
BLOCK_KERNEL = CudaKernel("deposit_block.cu", "rt3_deposit_block", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # wt, blk, wcmp
    ctypes.c_int, ctypes.c_int,                          # W, wchunk
    ctypes.c_int, ctypes.c_int,                          # n_tiles, tile
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # packed, dep, Dp
    ctypes.c_void_p,                                     # out
    *_GEOMETRY_ARGS,
], name="deposit_block")

#: csrc/deposit_stage.cuh's compiled constants: hit slots a thread holds
#: (kSlotsPerThread), lanes per staged stage (kStageLanes), stages in the
#: ring (kRing), deposit rows staged (kRows), the most threads a block
#: (kMaxThreads) and the dynamic shared memory a block gets without opting
#: in (kMaxSharedBytes).  The kernels refuse a geometry that does not fit
#: them, and a CPU test reads them back from the header.
SLOTS_PER_THREAD = 4
STAGE_LANES = 512
RING = 2
STAGED_ROWS = 9
MAX_THREADS = 256
MAX_SHARED_BYTES = 48 * 1024
#: Blocks per tile of the tile, block and stream deposits: the heaviest tile
#: holds ~1% of a round's lanes (16x the mean) on the paths' rounds, and
#: splitting every tile's stages 8 ways keeps it off the kernel's tail
#: (PERF.md section 6).  The lane deposit takes its own
#: (``lane_kernel.LANE_GRID_SPLITS``).
GRID_SPLITS = 8


@dataclass(frozen=True)
class DepositGeometry:
    """Launch geometry of the tile and block deposit kernels for one tile
    size (csrc/deposit_stage.cuh): ``slot_threads`` = ceil(tile / R)
    threads each hold R slots (thread q: slots q + k slot_threads, k < R),
    ``splits`` such groups share a block and split the lanes of every stage
    among them, and ``gsplits`` blocks per tile split the tile's stages
    (GRID_SPLITS unless the kernel chooses another)."""

    tile: int
    slot_threads: int
    splits: int
    gsplits: int
    threads: int
    shared_bytes: int

    def slots_of(self, thread: int) -> list[int]:
        """The tile slots ``thread`` accumulates (the kernel's mapping)."""
        q = thread % self.slot_threads
        return [s for s in range(q, self.slot_threads * SLOTS_PER_THREAD, self.slot_threads)
                if s < self.tile]

    def split_of(self, thread: int) -> int:
        return thread // self.slot_threads


def deposit_geometry(tile: int, gsplits: int = GRID_SPLITS) -> DepositGeometry:
    """The geometry for ``tile`` (1..1024) slots and ``gsplits`` blocks a
    tile: as many lane splits as fit in ``MAX_THREADS`` threads, and shared
    memory for the staging ring or, if larger, the splits' partial sums."""
    if not 1 <= tile <= 1024:
        raise ValueError(f"tile {tile} is not in 1..1024")
    if gsplits < 1:
        raise ValueError(f"gsplits {gsplits} is not at least 1")
    q = -(-tile // SLOTS_PER_THREAD)
    splits = max(1, MAX_THREADS // q)
    ring = RING * STAGED_ROWS * STAGE_LANES * 4
    partial_sums = (splits - 1) * tile * 16          # one float4 a slot and split
    return DepositGeometry(tile, q, splits, gsplits, q * splits, max(ring, partial_sums))


def _geometry_args(tile: int, c_pad: int, dev: torch.device):
    """(C arguments, scratch tensor to keep alive) of the launch geometry
    for ``tile``: the grid splits' partial sums go to scratch."""
    geom = deposit_geometry(tile)
    scratch = torch.empty((geom.gsplits, c_pad, 4), dtype=torch.float32, device=dev)
    args = (geom.threads, geom.splits, geom.gsplits, geom.shared_bytes, ptr(scratch))
    return args, scratch


def interval_pairs(tile_of: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   hp: torch.Tensor, dep_packed: torch.Tensor, pairs_per_step: int):
    """The pair tests of lane intervals against hit-point tiles, in steps.

    Interval k covers deposit lanes [lo[k], hi[k]) against the slots of tile
    ``tile_of[k]`` of ``hp`` (n_tiles, t, 8).  Yields (tile (P,), lane (P,),
    lane rows (9, P), mask (P, t) float32) for ``pairs_per_step // t`` lanes
    at a time, in order (interval, lane): the plain versions of the deposit
    kernels share it, so they take the same pairs.
    """
    t = hp.shape[1]
    lens = torch.clamp_min(hi.long() - lo.long(), 0)
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    total = int(ends[-1]) if ends.numel() else 0
    step = max(1, pairs_per_step // t)
    for i0 in range(0, total, step):
        item = torch.arange(i0, min(i0 + step, total), device=hp.device)
        k = torch.searchsorted(ends, item, right=True)
        lane = lo.long()[k] + (item - starts[k])
        tile = tile_of.long()[k]
        d = dep_packed[:9, lane]                              # (9, P)
        h = hp[tile]                                          # (P, t, 8)
        dx = h[..., 0] - d[0, :, None]
        dy = h[..., 1] - d[1, :, None]
        dz = h[..., 2] - d[2, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        ndot = h[..., 3] * d[3, :, None] + h[..., 4] * d[4, :, None] \
            + h[..., 5] * d[5, :, None]
        m = ((d2 <= h[..., 6]) & (ndot > NORMAL_DOT_MIN)).to(torch.float32)
        yield tile, lane, d, m


def intervals_plain(tile_of, lo, hi, packed: torch.Tensor, dep_packed: torch.Tensor,
                 n_tiles: int, pairs_per_step: int,
                 sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Count (col 0) and raw RGB flux (cols 1:4) per hit slot over the
    intervals' pair tests; (c_pad, 8), zero where no interval reaches.
    The flux is summed in ``sum_dtype`` (float64: each slot's sum rounded to
    float32 once, a witness for how far float32 summation orders stray)."""
    c_pad = packed.shape[0]
    t = c_pad // n_tiles
    dev = packed.device
    cnt = torch.zeros((n_tiles, t), dtype=torch.float32, device=dev)
    flux = torch.zeros((3, n_tiles, t), dtype=sum_dtype, device=dev)
    for tile, _, d, m in interval_pairs(tile_of, lo, hi, packed.reshape(n_tiles, t, 8),
                                        dep_packed, pairs_per_step):
        cnt.index_add_(0, tile, m)
        for c in range(3):
            flux[c].index_add_(0, tile, (m * d[6 + c, :, None]).to(sum_dtype))
    out = torch.zeros((c_pad, 8), dtype=torch.float32, device=dev)
    out[:, 0] = cnt.reshape(-1)
    out[:, 1:4] = flux.reshape(3, -1).T
    return out


def deposit_tile_plain(sk: torch.Tensor, ek: torch.Tensor, packed: torch.Tensor,
                       dep_packed: torch.Tensor, pairs_per_step: int = 1 << 22,
                       sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's contract in plain PyTorch, over tiles in steps.

    The (tile, deposit lane) items of all intervals are enumerated in
    order (tile, window, lane) and tested against the item's tile in
    steps of ``pairs_per_step // tile`` items, so a whole bench round fits
    in memory on the card.  ``sum_dtype``: see :func:`intervals_plain`.
    """
    n_tiles, K = sk.shape
    tile_of = torch.arange(n_tiles, device=sk.device).repeat_interleave(K)
    return intervals_plain(tile_of, sk.reshape(-1), ek.reshape(-1), packed,
                        dep_packed, n_tiles, pairs_per_step, sum_dtype)


def _deposit_tile_cuda(sk, ek, packed, dep_packed):
    dev = packed.device
    n_tiles, K = sk.shape
    c_pad = packed.shape[0]
    check("sk", sk, torch.int32, (n_tiles, K), dev)
    check("ek", ek, torch.int32, (n_tiles, K), dev)
    check("packed", packed, torch.float32, (c_pad, 8), dev)
    check("dep_packed", dep_packed, torch.float32, (16, None), dev)
    tile = c_pad // n_tiles
    if tile * n_tiles != c_pad or not 1 <= tile <= 1024:
        raise ValueError(f"c_pad {c_pad} is not n_tiles {n_tiles} tiles of "
                         "1..1024 slots")
    out = torch.empty((c_pad, 8), dtype=torch.float32, device=dev)
    gargs, scratch = _geometry_args(tile, c_pad, dev)
    KERNEL.launch(dev, ptr(sk), ptr(ek), n_tiles, K, tile, ptr(packed),
                  ptr(dep_packed), dep_packed.shape[1], ptr(out), *gargs)
    del scratch     # the stream orders its reuse after the kernel
    return out


def deposit_tile(sk: torch.Tensor, ek: torch.Tensor, packed: torch.Tensor,
                 dep_packed: torch.Tensor) -> torch.Tensor:
    """Count (col 0) and raw RGB flux (cols 1:4) per hit slot, (c_pad, 8).

    ``sk``, ``ek``: (n_tiles, K) int32 cascaded lane intervals;
    ``packed``: (c_pad, 8) hit slots; ``dep_packed``: (16, Dp) sorted
    deposits.  CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`deposit_tile_plain`.
    """
    if packed.is_cuda:
        return _deposit_tile_cuda(sk, ek, packed, dep_packed)
    if packed.device.type == "cpu":
        return deposit_tile_plain(sk, ek, packed, dep_packed)
    raise ValueError(f"no deposit kernel for device {packed.device}")


def deposit_block_plain(wt: torch.Tensor, blk: torch.Tensor, wcmp: torch.Tensor,
                        packed: torch.Tensor, dep_packed: torch.Tensor, tile: int,
                        wchunk: int, pairs_per_step: int = 1 << 22,
                        sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel #5's contract in plain PyTorch: count (col 0) and raw RGB flux
    (cols 1:4) per hit slot of tile ``wt[s]`` over the whole deposit block
    ``blk[s]`` (lanes [blk wchunk, (blk + 1) wchunk)) of every item with
    ``wcmp[s] != 0``; tiles no item names read 0.  ``sum_dtype``: see
    :func:`intervals_plain`."""
    on = wcmp != 0
    lo = blk.long()[on] * wchunk
    hi = torch.clamp_max(lo + wchunk, dep_packed.shape[1])
    return intervals_plain(wt.long()[on], lo, hi, packed, dep_packed,
                           packed.shape[0] // tile, pairs_per_step, sum_dtype)


def _deposit_block_cuda(wt, blk, wcmp, packed, dep_packed, tile, wchunk):
    dev = packed.device
    W = wt.shape[0]
    c_pad = packed.shape[0]
    for name, x in (("wt", wt), ("blk", blk), ("wcmp", wcmp)):
        check(name, x, torch.int32, (W,), dev)
    check("packed", packed, torch.float32, (c_pad, 8), dev)
    check("dep_packed", dep_packed, torch.float32, (16, None), dev)
    if not 1 <= tile <= 1024 or c_pad % tile:
        raise ValueError(f"c_pad {c_pad} is not a whole number of tiles of "
                         f"{tile} (1..1024) slots")
    if wchunk < 1 or dep_packed.shape[1] % wchunk:
        raise ValueError(f"Dp {dep_packed.shape[1]} is not whole blocks of {wchunk} lanes")
    out = torch.empty((c_pad, 8), dtype=torch.float32, device=dev)
    gargs, scratch = _geometry_args(tile, c_pad, dev)
    BLOCK_KERNEL.launch(dev, ptr(wt), ptr(blk), ptr(wcmp), W, wchunk, c_pad // tile,
                        tile, ptr(packed), ptr(dep_packed), dep_packed.shape[1], ptr(out),
                        *gargs)
    del scratch     # the stream orders its reuse after the kernel
    return out


def deposit_block(wt: torch.Tensor, blk: torch.Tensor, wcmp: torch.Tensor,
                  packed: torch.Tensor, dep_packed: torch.Tensor, tile: int,
                  wchunk: int) -> torch.Tensor:
    """Count (col 0) and raw RGB flux (cols 1:4) per hit slot, (c_pad, 8).

    ``wt``, ``blk``, ``wcmp``: (W,) int32 work items sorted by tile: the
    item's tile, its deposit block of ``wchunk`` lanes and whether it
    computes; ``packed``: (c_pad, 8) hit slots in tiles of ``tile``;
    ``dep_packed``: (16, Dp) sorted deposits, Dp a multiple of ``wchunk``.
    A tile that no item names reads 0.  CUDA tensors launch kernel #5 (or
    raise); CPU tensors take :func:`deposit_block_plain`.
    """
    if packed.is_cuda:
        return _deposit_block_cuda(wt, blk, wcmp, packed, dep_packed, tile, wchunk)
    if packed.device.type == "cpu":
        return deposit_block_plain(wt, blk, wcmp, packed, dep_packed, tile, wchunk)
    raise ValueError(f"no block deposit kernel for device {packed.device}")


def _cascade(s: torch.Tensor, e: torch.Tensor):
    """(n_tiles, K) intervals made disjoint: each start moves past the
    previous window's end (windows are in key order)."""
    prev_e = torch.zeros_like(s[:, 0])
    s_cols, e_cols = [], []
    for k in range(s.shape[1]):
        s_k = torch.maximum(s[:, k], prev_e)
        e_k = torch.maximum(e[:, k], s_k)
        s_cols.append(s_k)
        e_cols.append(e_k)
        prev_e = e_k
    return torch.stack(s_cols, 1), torch.stack(e_cols, 1)


@dataclass
class HpLayout(Record):
    """Round-invariant hit-point side of the banded deposit (one per pass)."""

    packed: torch.Tensor    # (c_pad, 8): pos xyz, n xyz, r2 slot, unused
    g: torch.Tensor         # (C,) int64 layout slot of hit point i
    lo_keys: torch.Tensor   # (n_tiles, K) int32 window lower keys
    hi_keys: torch.Tensor   # (n_tiles, K) int32 window upper keys


class DepositTile:
    """``deposit_fn(hp, dep) -> (d_nphot, d_tao, overflow)``, banded.

    ``prepare(hp)`` builds the hit-point layout once per pass;
    ``pack_state``/``packed_call`` let ``photon_rounds`` run every round in
    layout space.  There is no work cap, so ``overflow`` is always 0.
    """

    #: calls return (d_nphot, d_tao, overflow)
    returns_aux = True

    def __init__(self, tile: int = 256, chunk: int = 2048, axes=(0, 1),
                 search_r: float = SEARCH_R, x_lo: float = DEFAULT_X_LO,
                 x_hi: float = DEFAULT_X_HI, y_lo: float = Y_LO,
                 y_hi: float = Y_HI, bucket2d: bool = False,
                 z_lo: float = DEFAULT_Z_LO, z_hi: float = DEFAULT_Z_HI):
        self.tile = tile
        #: deposit lanes are padded to a multiple of this (JAX parity)
        self.chunk = chunk
        self.ax, self.ay = axes
        self.search_r = search_r
        self.bucket = 2.0 * search_r
        self.x_lo = x_lo
        self.n_bx = int(math.ceil((x_hi - x_lo) / self.bucket)) + 1
        self.bucket2d = bucket2d
        #: the second bucketed axis of 2-D banding
        self.az = 2
        self.z_lo = z_lo
        self.n_bz = int(math.ceil((z_hi - z_lo) / self.bucket)) + 1 if bucket2d else 1
        self.n_buckets = self.n_bx * self.n_bz
        self.y_lo = y_lo
        self.y_range = int(math.ceil((y_hi - y_lo) * YQ))
        self.y_stride = self.y_range + 2
        #: window bucket offsets, ascending (key order): the x neighbours
        #: (1-D) or the 3 x 3 (x, z) neighbourhood (2-D); a kz at the z
        #: boundary wraps into a real bucket, which only adds candidates
        if bucket2d:
            self.win_offs = [dx * self.n_bz + dz for dx in (-1, 0, 1)
                             for dz in (-1, 0, 1)]
        else:
            self.win_offs = [-1, 0, 1]
        #: lower / upper bucket offset per window (DepositLane's merged z
        #: windows give them different values)
        self.win_offs_lo = self.win_offs
        self.win_offs_hi = self.win_offs

    # -- helpers -----------------------------------------------------------
    def _bid(self, pos: torch.Tensor) -> torch.Tensor:
        """Bucket id per row of ``pos`` (int32)."""
        kx = torch.floor((pos[:, self.ax] - self.x_lo) / self.bucket)
        kx = torch.clamp(kx.to(torch.int32), 0, self.n_bx - 1)
        if not self.bucket2d:
            return kx
        kz = torch.floor((pos[:, self.az] - self.z_lo) / self.bucket)
        return kx * self.n_bz + torch.clamp(kz.to(torch.int32), 0, self.n_bz - 1)

    def _yq(self, y: torch.Tensor) -> torch.Tensor:
        """Quantized sort coordinate (floor; conservative with ceil hi)."""
        return torch.clamp(torch.floor((y - self.y_lo) * YQ).to(torch.int32),
                           0, self.y_range - 1)

    def _c_pad(self, C: int) -> int:
        t = self.tile
        return ((C + t - 1) // t) * t + (self.n_buckets + 1) * t

    def _build_windows(self, packed, tv, kb, ylo_q, yhi_q):
        """Per-tile (lo_keys, hi_keys), (n_tiles, K) each: the windows
        around the tile's own bucket ``kb``, over the tile's y range.
        ``packed`` (c_pad, 8) and ``tv`` (n_tiles, tile), the slots' valid
        mask, serve layouts whose windows depend on the tile's points."""
        lo = [(kb + o) * self.y_stride + ylo_q for o in self.win_offs_lo]
        hi = [(kb + o) * self.y_stride + yhi_q for o in self.win_offs_hi]
        return torch.stack(lo, 1), torch.stack(hi, 1)

    def _sentinel_key(self) -> int:
        """Key for invalid deposit lanes: beyond every window."""
        return (self.n_buckets + self.n_bz + 2) * self.y_stride

    # -- once per pass -----------------------------------------------------
    @torch.no_grad()
    def prepare(self, hp: HitPoints) -> HpLayout:
        """The layout orders and pads by position only: the box kernel's
        derivative there is zero, so it is built without autograd."""
        t = self.tile
        C = hp.capacity
        nb = self.n_buckets
        dev = hp.pos.device
        hkx = torch.where(hp.valid, self._bid(hp.pos), nb).to(torch.int32)
        hkey = hkx * self.y_stride + torch.where(
            hp.valid, self._yq(hp.pos[:, self.ay]), 0)
        _, h_ord = torch.sort(hkey, stable=True)
        kx_sorted = hkx[h_ord]

        counts = torch.bincount(kx_sorted, minlength=nb + 1)
        padded = ((counts + t - 1) // t) * t
        offsets = torch.cumsum(padded, 0) - padded
        # Rank within the bucket run: index minus the run's first index.
        i_arange = torch.arange(C, device=dev)
        is_start = torch.ones((C,), dtype=torch.bool, device=dev)
        is_start[1:] = kx_sorted[1:] != kx_sorted[:-1]
        first_idx = torch.cummax(torch.where(is_start, i_arange, 0), 0).values
        dest = offsets[kx_sorted.long()] + (i_arange - first_idx)

        c_pad = self._c_pad(C)
        packed = torch.full((c_pad, 8), FAR, dtype=torch.float32, device=dev)
        rows = torch.cat([hp.pos, hp.n,
                          torch.full((C, 1), -1.0, device=dev),
                          torch.zeros((C, 1), device=dev)], 1)
        packed[dest] = rows[h_ord]
        # Padding slots keep finite normals (r2 = -1 kills their test).
        packed[:, 3:6] = torch.where(packed[:, 3:6] >= FAR, 0.0, packed[:, 3:6])

        n_tiles = c_pad // t
        slot_kx = torch.zeros((c_pad,), dtype=torch.int32, device=dev)
        slot_kx[dest] = kx_sorted
        kb = slot_kx.reshape(n_tiles, t).amax(1)
        tv = torch.zeros((c_pad,), dtype=torch.bool, device=dev)
        tv[dest] = hp.valid[h_ord]
        tv = tv.reshape(n_tiles, t)
        ty = packed[:, self.ay].reshape(n_tiles, t)
        y_lo = torch.where(tv, ty, torch.inf).amin(1) - self.search_r
        y_hi = torch.where(tv, ty, -torch.inf).amax(1) + self.search_r
        dead = ~torch.isfinite(y_lo)
        # Conservative quantized bounds: floor for lo, ceil for hi; lo tops
        # out at y_range - 1 to match _yq's clip.
        ylo_q = torch.clamp(torch.floor((y_lo - self.y_lo) * YQ), -1e9,
                            self.y_range - 1).to(torch.int32)
        yhi_q = torch.clamp(torch.ceil((y_hi - self.y_lo) * YQ), -1e9,
                            self.y_range).to(torch.int32)
        lo_keys, hi_keys = self._build_windows(packed, tv, kb, ylo_q, yhi_q)
        big = self._sentinel_key() + self.y_stride
        lo_keys = torch.where(dead[:, None], big, lo_keys).to(torch.int32)
        hi_keys = torch.where(dead[:, None], big, hi_keys).to(torch.int32)
        g = torch.zeros((C,), dtype=torch.int64, device=dev)
        g[h_ord] = dest
        return HpLayout(packed=packed, g=g, lo_keys=lo_keys, hi_keys=hi_keys)

    # -- per round ---------------------------------------------------------
    def _dep_rows(self, dep: Deposits):
        """(sort key (D,) int32, rows (D, 9)) of the round's deposits: the
        band key (the sentinel for invalid ones) and pos xyz (FAR for
        invalid), n xyz, flux rgb (0 for invalid)."""
        dkey = torch.where(
            dep.valid,
            self._bid(dep.pos) * self.y_stride + self._yq(dep.pos[:, self.ay]),
            self._sentinel_key()).to(torch.int32)
        okc = dep.valid[:, None]
        rows = torch.cat([torch.where(okc, dep.pos, FAR), dep.n,
                          torch.where(okc, dep.flux, 0.0)], 1)
        return dkey, rows

    def _dep_sorted(self, dep: Deposits, granularity: int,
                    with_order: bool = False):
        """Sort and pack the round's deposits: (dkeys, dep_packed, Dp), and
        with ``with_order`` also the permutation (D,) that sorted them (the
        backward unsorts with it).

        ``dep_packed`` is (16, Dp), Dp a multiple of ``granularity``; rows
        pos xyz (FAR for invalid), n xyz, flux rgb (0 for invalid), zeros.
        """
        D = dep.pos.shape[0]
        Dp = ((D + granularity - 1) // granularity) * granularity
        dkey, rows = self._dep_rows(dep)
        dkeys, order = torch.sort(dkey, stable=True)
        dep_packed = torch.zeros((16, Dp), dtype=torch.float32,
                                 device=dep.pos.device)
        dep_packed[0:3] = FAR
        dep_packed[0:9, :D] = rows[order].T
        if with_order:
            return dkeys, dep_packed, Dp, order
        return dkeys, dep_packed, Dp

    def _raw_window_lanes(self, prep: HpLayout, dkeys: torch.Tensor, n_tiles: int):
        """Per-(tile, window) lane intervals [s, e) of the window keys,
        before the cascade."""
        K = len(self.win_offs)
        s_lane = torch.searchsorted(dkeys, prep.lo_keys.reshape(-1)).reshape(n_tiles, K)
        e_lane = torch.searchsorted(dkeys, prep.hi_keys.reshape(-1),
                                    right=True).reshape(n_tiles, K)
        return s_lane, e_lane

    def _window_lanes(self, prep: HpLayout, dkeys: torch.Tensor, n_tiles: int):
        """Per-(tile, window) lane intervals [s, e), disjoint via a cascade:
        each start moves past the previous window's end."""
        return _cascade(*self._raw_window_lanes(prep, dkeys, n_tiles))

    def _kernel_call(self, packed: torch.Tensor, dep: Deposits, prep: HpLayout):
        n_tiles = packed.shape[0] // self.tile
        dkeys, dep_packed, _ = self._dep_sorted(dep, self.chunk)
        sk, ek = self._window_lanes(prep, dkeys, n_tiles)
        out = deposit_tile(sk.to(torch.int32).contiguous(),
                           ek.to(torch.int32).contiguous(), packed, dep_packed)
        overflow = torch.zeros((), dtype=torch.int32, device=packed.device)
        return out[:, 0], out[:, 1:4], overflow

    # -- layout-space interface (state packed for the whole pass) ----------
    def pack_state(self, hp: HitPoints, prep: HpLayout):
        """Scatter per-pass state into layout space once: (r2_pad, wgt_pad)."""
        c_pad = self._c_pad(hp.capacity)
        r2_pad = torch.full((c_pad,), -1.0, dtype=torch.float32, device=hp.r2.device)
        r2_pad[prep.g] = torch.where(hp.valid, hp.r2, -1.0)
        wgt_pad = torch.zeros((c_pad, 3), dtype=torch.float32, device=hp.r2.device)
        wgt_pad[prep.g] = hp.wgt
        return r2_pad, wgt_pad

    def unpack_state(self, prep: HpLayout, *cols):
        """Gather layout-space arrays back to hit-point order."""
        return tuple(c[prep.g] for c in cols)

    def packed_call(self, r2_pad: torch.Tensor, dep: Deposits, prep: HpLayout):
        """Layout-space deposit: (cnt_pad, flux_pad, overflow); the caller
        applies wgt * flux / pi (Raytracer.h:156)."""
        packed = prep.packed.clone()
        packed[:, 6] = r2_pad
        return self._kernel_call(packed, dep, prep)

    def __call__(self, hp: HitPoints, dep: Deposits, prep: HpLayout | None = None):
        if prep is None:
            prep = self.prepare(hp)
        packed = prep.packed.clone()
        packed[prep.g, 6] = torch.where(hp.valid, hp.r2, -1.0)
        cnt_pad, fl_pad, overflow = self._kernel_call(packed, dep, prep)
        cnt, fl = self.unpack_state(prep, cnt_pad, fl_pad)
        return cnt, hp.wgt * fl / math.pi, overflow


class DepositBlock(DepositTile):
    """``deposit_fn(hp, dep) -> (d_nphot, d_tao, overflow)``, block-granular
    (``PallasDeposit``, the CLI's ``--deposit pallas``).

    Each tile's window intervals widen to whole ``wchunk``-aligned deposit
    blocks, cascaded at block granularity so that no block is counted twice
    (a lane of a fetched block that is no neighbour fails the pair test:
    adjacent buckets lie 2r apart, invalid lanes at 1e9).  Every tile gets
    at least one item, so that its output row is written.  Items beyond
    ``work_cap`` are dropped: a tile straddling the cap keeps its partial
    sums, a tile whose first item lies beyond it reads 0, and ``overflow``
    = (items - W) x wchunk bounds the candidate lanes skipped
    (``photon_rounds`` folds it into ``deposits_dropped``).
    """

    def __init__(self, tile: int = 512, wchunk: int = 1024, work_cap: int = 8192, **kw):
        super().__init__(tile=tile, chunk=wchunk, **kw)
        self.wchunk = wchunk
        self.work_cap = work_cap

    def work_list(self, prep: HpLayout, dkeys: torch.Tensor, n_tiles: int, Dp: int):
        """Kernel #5's work list (deposit_pallas.py:440-527): (wt, blk, wcmp),
        each (W,) int32 sorted by tile, ``overflow`` (int32) and ``total``,
        the number of items the round needs.  Pad items beyond the real ones
        repeat the last real item's tile and block and compute nothing."""
        wc, W = self.wchunk, self.work_cap
        if W < n_tiles + 1:
            raise ValueError(f"work_cap {W} must exceed the tile count {n_tiles}")
        n_blocks = Dp // wc
        s_lane, e_lane = self._raw_window_lanes(prep, dkeys, n_tiles)
        live = e_lane > s_lane
        sb = torch.where(live, s_lane // wc, 0)
        eb = torch.where(live, (e_lane + wc - 1) // wc, 0)
        s_win, e_win = _cascade(sb, eb)
        nc = torch.clamp_min(e_win - s_win, 0)
        nc_tile = nc.sum(1)
        items = torch.clamp_min(nc_tile, 1)        # every tile writes its row
        cum = torch.cumsum(items, 0)
        total = cum[-1]
        s_idx = torch.arange(W, device=dkeys.device)
        wt = torch.clamp_max(torch.searchsorted(cum, s_idx, right=True), n_tiles - 1)
        j = s_idx - (cum[wt] - items[wt])
        K = nc.shape[1]
        ncc_w = torch.cumsum(nc, 1)[wt]                     # (W, K)
        w_id = torch.clamp_max((j[:, None] >= ncc_w).sum(1), K - 1)
        prev = torch.gather(ncc_w, 1, torch.clamp_min(w_id - 1, 0)[:, None])[:, 0]
        prev = torch.where(w_id > 0, prev, 0)
        blk = torch.gather(s_win[wt], 1, w_id[:, None])[:, 0] + (j - prev)
        real = s_idx < total
        compute = real & (j < nc_tile[wt])
        blk = torch.clamp(blk, 0, n_blocks - 1)
        last = torch.clamp_max(total - 1, W - 1)
        i32 = lambda x: x.to(torch.int32).contiguous()
        overflow = (torch.clamp_min(total - W, 0) * wc).to(torch.int32)
        return (i32(torch.where(real, wt, wt[last])), i32(torch.where(real, blk, blk[last])),
                i32(compute), overflow, total)

    def _kernel_call(self, packed: torch.Tensor, dep: Deposits, prep: HpLayout):
        """(cnt_pad, flux_pad, overflow) in layout space, through kernel #5."""
        n_tiles = packed.shape[0] // self.tile
        dkeys, dep_packed, Dp = self._dep_sorted(dep, self.wchunk)
        wt, blk, wcmp, overflow, _ = self.work_list(prep, dkeys, n_tiles, Dp)
        out = deposit_block(wt, blk, wcmp, packed, dep_packed, self.tile, self.wchunk)
        return out[:, 0], out[:, 1:4], overflow


class DepositZTile(DepositTile):
    """Two-level banded tile deposit (``PallasDepositZTile``): coarse z
    buckets (``z_coarse``, default 8 x 2r) inside each 2r x band, so that
    a tile on a dense wall slab fetches its own z bucket's y window and not
    the slab's whole z extent.

    Keys are (kx, coarse kz, quantized y); per tile K = 6 windows: for each
    dx in (-1, 0, 1), slot A is the tile's lowest overlapped z bucket and
    slot B the buckets above it up to its highest (empty when the tile
    fits one bucket), each over the tile's y window.  Windows are supersets
    and the pair test is the filter.  It runs on ``deposit_tile`` (no
    kernel of its own) and has no cap.
    """

    def __init__(self, tile: int = 128, chunk: int = 1024,
                 z_coarse: float = 8.0 * 2.0 * SEARCH_R, z_lo: float = DEFAULT_Z_LO,
                 z_hi: float = DEFAULT_Z_HI, **kw):
        kw["bucket2d"] = False
        super().__init__(tile=tile, chunk=chunk, z_lo=z_lo, z_hi=z_hi, **kw)
        self.z_coarse = float(z_coarse)
        self.n_bzc = int(math.ceil((z_hi - z_lo) / self.z_coarse)) + 1
        self.n_buckets = self.n_bx * self.n_bzc
        # K = 6 windows, built per tile in _build_windows.
        self.win_offs = [0] * 6
        self.win_offs_lo = self.win_offs
        self.win_offs_hi = self.win_offs

    def _bid(self, pos: torch.Tensor) -> torch.Tensor:
        kx = torch.floor((pos[:, self.ax] - self.x_lo) / self.bucket)
        kx = torch.clamp(kx.to(torch.int32), 0, self.n_bx - 1)
        kz = torch.floor((pos[:, self.az] - self.z_lo) / self.z_coarse)
        return kx * self.n_bzc + torch.clamp(kz.to(torch.int32), 0, self.n_bzc - 1)

    def _sentinel_key(self) -> int:
        # Above every window: hi windows reach bucket n_buckets + n_bzc - 1.
        return (self.n_buckets + self.n_bzc + 2) * self.y_stride

    def _build_windows(self, packed, tv, kb, ylo_q, yhi_q):
        n_tiles, t = kb.shape[0], self.tile
        kx_t = kb // self.n_bzc
        tz = packed[:, self.az].reshape(n_tiles, t)
        z_lo_t = torch.where(tv, tz, torch.inf).amin(1) - self.search_r
        z_hi_t = torch.where(tv, tz, -torch.inf).amax(1) + self.search_r
        # Dead tiles read inf here; prepare() gives them the sentinel.
        kz = lambda z: torch.clamp(torch.floor((z - self.z_lo) / self.z_coarse),
                                   0, self.n_bzc - 1).to(torch.int32)
        kz_lo, kz_hi = kz(z_lo_t), kz(z_hi_t)
        lo, hi = [], []
        for dx in (-1, 0, 1):
            b = (kx_t + dx) * self.n_bzc
            lo += [(b + kz_lo) * self.y_stride + ylo_q, (b + kz_lo + 1) * self.y_stride + ylo_q]
            hi += [(b + kz_lo) * self.y_stride + yhi_q, (b + kz_hi) * self.y_stride + yhi_q]
        return torch.stack(lo, 1), torch.stack(hi, 1)


def world_bounds_from_scene(scene, margin: float = 4.0 * SEARCH_R,
                            extra_points=None) -> dict:
    """Deposit world bounds from the scene's finite geometry (spheres,
    Bezier control points, lights, the pinned axes of axis-aligned planes,
    ``extra_points``), padded by ``margin``.  Bounds only affect speed:
    out-of-range positions clamp into the boundary buckets."""
    npf = lambda x: x.detach().cpu().numpy().astype(np.float64)
    pts = [npf(scene.light_pos)]
    if scene.spheres.count:
        c = npf(scene.spheres.center)
        r = npf(scene.spheres.radius)[:, None]
        pts += [c - r, c + r]
    if scene.has_bezier:
        pts.append(npf(scene.bezier.ctrl).reshape(-1, 3))
    if extra_points is not None:
        pts.append(np.asarray(extra_points, np.float64).reshape(-1, 3))
    P = np.concatenate(pts, 0)
    lo, hi = P.min(0), P.max(0)
    n = npf(scene.planes.normal)
    p0 = npf(scene.planes.p0)
    for i in range(n.shape[0]):
        ax = int(np.argmax(np.abs(n[i])))
        if abs(n[i, ax]) > 0.999:       # an axis-aligned plane pins its axis
            lo[ax] = min(lo[ax], p0[i, ax])
            hi[ax] = max(hi[ax], p0[i, ax])
    lo -= margin
    hi += margin
    return dict(x_lo=float(lo[0]), x_hi=float(hi[0]),
                y_lo=float(lo[1]), y_hi=float(hi[1]),
                z_lo=float(lo[2]), z_hi=float(hi[2]))


def make_tile_deposit(**kw) -> DepositTile:
    """The bench's deposit (``make_pallas_deposit``): tile 256, 1-D banding."""
    kw.setdefault("tile", 256)
    kw.setdefault("chunk", 2048)
    return DepositTile(**kw)
