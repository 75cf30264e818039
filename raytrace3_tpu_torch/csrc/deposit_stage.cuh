// Register-blocked pair loop fed by an asynchronous staging ring, shared by
// the tile deposit (deposit_tile.cu), the block deposit (deposit_block.cu),
// the stream deposit (deposit_stream.cu) and the lane deposit
// (deposit_lane.cu).
//
// Work of one CUDA block: one hit-point tile of `tile` slots against a
// sequence of deposit-lane intervals [a, b) (the tile's cascaded windows,
// its work items' whole blocks, or its stream or lane items' masks).  The pair test is deposit_pair.cuh's
// pair_passes, so the counts equal the plain PyTorch versions' exactly.
//
// Geometry (computed by the wrapper, ops/deposit_kernel.py:
// deposit_geometry, passed in, and refused by launch_deposit unless it is
// the one these constants give):
//   * register blocking: a thread holds kSlotsPerThread = R hit slots,
//     slot q + k Q of the tile (k < R, Q = ceil(tile / R) "slot threads"),
//     so every lane it reads from shared memory serves R pair tests;
//   * lane splits: blockDim = Q x splits; split p (threads [p Q, (p+1) Q))
//     tests the 4-lane groups p, p + splits, ... of every stage, and the
//     splits' partial sums are added in split order at the end (through
//     shared memory, so the result does not depend on timing);
//   * grid splits: blockIdx.y of gridDim.y takes every gridDim.y-th stage
//     of the tile's sequence and writes its partial sums (cnt, flux rgb)
//     to scratch[blockIdx.y]; combine_partials adds them in order.  Each
//     kernel's wrapper chooses gridDim.y (8 for the tile, block and stream
//     deposits; the lane deposit's items are shorter than a stage).
// Staging: the lanes of an interval are cut into stages of kStageLanes,
// each starting at a lane aligned down to 4 (16 bytes), so rows 0-8 of a
// stage are copied with 16-byte cp.async (4-byte copies when Dp or the
// deposit array is not 16-byte aligned) into a ring of kRing buffers; the
// next stage is in flight while the current one is tested, and one
// __syncthreads() per stage remains.  The groups of 4 lanes are read as
// float4 (one 128-bit broadcast load per row); lanes of a group outside
// [a, b) (the head and tail of an interval) get a zero normal in registers,
// so n_h . 0 = 0 fails the test whatever the shared memory holds there.
// Accumulation: a pair that passes sets one bit of a 32-bit word per slot
// (8 groups x 4 lanes; one predicated OR a pair), and after each word the
// slot's count takes the word's popcount and its flux the flux rows of the
// set bits' lanes, in lane order.  Adding count and flux with predicated
// adds instead costs 4 instruction slots a pair test, taken or not; here they
// cost about one, as pairs pass rarely.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "deposit_pair.cuh"

namespace rt3 {

// ops/deposit_kernel.py holds the same values (SLOTS_PER_THREAD, ...); a
// CPU test reads them back from this file.
constexpr int kSlotsPerThread = 4;
constexpr int kStageLanes = 512;
constexpr int kRing = 2;
constexpr int kRows = 9;                    // pos xyz, n xyz, flux rgb
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 2;               // blocks an SM must hold (registers)
constexpr int kMaxTile = 1024;
constexpr int kMaxSharedBytes = 48 * 1024;  // dynamic shared memory without opt-in
static_assert(kStageLanes % 4 == 0, "stages hold whole 4-lane groups");

// Dynamic shared memory: the staging ring (kRing * kRows * kStageLanes * 4
// bytes); the end of the kernel reuses it for the splits' partial sums (one
// float4 a slot and split).
extern __shared__ float4 stage_smem[];

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One stage: lanes [base + lo, base + hi) of the deposit array, staged at
// columns [lo, hi) of a ring buffer; base is a multiple of 4 and
// 0 <= lo < hi <= kStageLanes.
struct Stage {
  long long base;
  int lo, hi;
};

// Walks the stages of a sequence of lane intervals.  `Src` gives
// src.count() intervals and src.get(i, a, b) clipped to [0, Dp) (a >= b
// for an empty one).  Every thread of the block walks the same sequence.
template <class Src>
struct StageIter {
  const Src& src;
  int i = -1;
  long long a = 0, b = 0, base = 0;

  __device__ explicit StageIter(const Src& s) : src(s) {}

  __device__ bool next(Stage& st) {
    while (base >= b) {                     // the current interval is done
      if (++i >= src.count()) return false;
      src.get(i, a, b);
      base = a < b ? (a & ~3LL) : b;
    }
    st.base = base;
    st.lo = (int)(max(a, base) - base);
    st.hi = (int)(min(b, base + kStageLanes) - base);
    base += kStageLanes;
    return true;
  }

  // The next stage of this grid split: every `every`-th stage, from `first`.
  __device__ bool next_own(Stage& st, int& index, int first, int every) {
    while (next(st)) {
      if (index++ % every == first) return true;
    }
    return false;
  }
};

// Copies rows 0-8 of a stage's lanes into `buf` ([kRows][kStageLanes]);
// commits one cp.async group.  Only lanes [lo, hi), widened to whole
// 4-lane groups on the 16-byte path, are copied.
__device__ __forceinline__ void copy_stage(float* buf, const Stage& st,
                                            const float* __restrict__ dep, long long dp,
                                            bool vec) {
  const int nthreads = blockDim.x;
  if (vec) {
    const int g0 = st.lo >> 2, g1 = (st.hi + 3) >> 2, ng = g1 - g0;
    for (int i = threadIdx.x; i < kRows * ng; i += nthreads) {
      const int row = i / ng, col = (g0 + i % ng) * 4;
      cp_async16(buf + row * kStageLanes + col, dep + row * dp + st.base + col);
    }
  } else {
    const int n = st.hi - st.lo;
    for (int i = threadIdx.x; i < kRows * n; i += nthreads) {
      const int row = i / n, col = st.lo + i % n;
      cp_async4(buf + row * kStageLanes + col, dep + row * dp + st.base + col);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A thread's sums for its slots: count (exact in fp32) and flux rgb.
struct Acc {
  float cnt[kSlotsPerThread], f0[kSlotsPerThread], f1[kSlotsPerThread],
      f2[kSlotsPerThread];
};

// The 4 lanes of group `col` (a multiple of 4): rows 0-5 as float4.  kMask:
// lanes outside [lo, hi) take a zero normal, so they never pass.
struct Group {
  float4 px, py, pz, nx, ny, nz;
};

template <bool kMask>
__device__ __forceinline__ Group load_group(const float* __restrict__ buf, int col, int lo,
                                            int hi) {
  const float4* r = reinterpret_cast<const float4*>(buf + col);
  constexpr int kRowStride = kStageLanes / 4;
  Group g{r[0], r[kRowStride], r[2 * kRowStride], r[3 * kRowStride], r[4 * kRowStride],
          r[5 * kRowStride]};
  if (kMask) {
    const bool in0 = col >= lo && col < hi, in1 = col + 1 >= lo && col + 1 < hi;
    const bool in2 = col + 2 >= lo && col + 2 < hi, in3 = col + 3 >= lo && col + 3 < hi;
    g.nx = make_float4(in0 ? g.nx.x : 0.f, in1 ? g.nx.y : 0.f, in2 ? g.nx.z : 0.f,
                       in3 ? g.nx.w : 0.f);
    g.ny = make_float4(in0 ? g.ny.x : 0.f, in1 ? g.ny.y : 0.f, in2 ? g.ny.z : 0.f,
                       in3 ? g.ny.w : 0.f);
    g.nz = make_float4(in0 ? g.nz.x : 0.f, in1 ? g.nz.y : 0.f, in2 ? g.nz.z : 0.f,
                       in3 ? g.nz.w : 0.f);
  }
  return g;
}

// Sets bit `bit0 + j` of bits[k] when lane j of the group passes against
// slot k: one predicated OR a pair besides the test itself.
__device__ __forceinline__ void test_group(const Group& g, int bit0,
                                           const HitSlot (&h)[kSlotsPerThread],
                                           unsigned (&bits)[kSlotsPerThread]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x = lane_of(g.px, j), y = lane_of(g.py, j), z = lane_of(g.pz, j);
    const float dnx = lane_of(g.nx, j), dny = lane_of(g.ny, j), dnz = lane_of(g.nz, j);
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      if (pair_passes(h[k], x, y, z, dnx, dny, dnz)) bits[k] |= 1u << (bit0 + j);
    }
  }
}

// Adds the pairs of bits[k] to slot k: the count, and the flux of each set
// bit's lane in bit order; bit b is lane col_of(b) of the staged stage.
// Pairs pass rarely (0.4-0.5% on the paths' rounds), so this costs about
// one instruction a pair test.
template <class ColOf>
__device__ __forceinline__ void add_bits(const float* __restrict__ buf,
                                         unsigned (&bits)[kSlotsPerThread], ColOf col_of,
                                         Acc& acc) {
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    unsigned m = bits[k];
    if (m == 0) continue;
    acc.cnt[k] += (float)__popc(m);
    do {
      const int col = col_of(__ffs(m) - 1);
      acc.f0[k] += buf[6 * kStageLanes + col];
      acc.f1[k] += buf[7 * kStageLanes + col];
      acc.f2[k] += buf[8 * kStageLanes + col];
      m &= m - 1;
    } while (m);
  }
}

// A masked group alone (the head or tail of an interval in a stage).
__device__ __forceinline__ void test_partial_group(const float* __restrict__ buf, int col,
                                                   int lo, int hi,
                                                   const HitSlot (&h)[kSlotsPerThread],
                                                   Acc& acc) {
  unsigned bits[kSlotsPerThread] = {};
  test_group(load_group<true>(buf, col, lo, hi), 0, h, bits);
  add_bits(buf, bits, [col](int b) { return col + b; }, acc);
}

// Groups of one bit word: 8 groups of 4 lanes.
constexpr int kGroupsPerWord = 8;

// Tests one staged stage: split p takes the whole groups p, p + splits, ...,
// 8 at a time into one bit word per slot; split 0 the partial head group and
// split splits - 1 the partial tail.
__device__ __forceinline__ void test_stage(const float* __restrict__ buf, const Stage& st,
                                           int p, int splits,
                                           const HitSlot (&h)[kSlotsPerThread], Acc& acc) {
  const int g_lo = st.lo >> 2, g_hi = (st.hi + 3) >> 2;       // groups touched
  const int i_lo = (st.lo + 3) >> 2, i_hi = st.hi >> 2;       // whole groups
  if (i_lo > i_hi) {                        // the stage lies inside one group
    if (p == 0) test_partial_group(buf, g_lo * 4, st.lo, st.hi, h, acc);
    return;
  }
  if (g_lo < i_lo && p == 0) test_partial_group(buf, g_lo * 4, st.lo, st.hi, h, acc);
  if (i_hi < g_hi && p == splits - 1) test_partial_group(buf, i_hi * 4, st.lo, st.hi, h, acc);
#pragma unroll 1
  for (int g0 = i_lo + p; g0 < i_hi; g0 += kGroupsPerWord * splits) {
    unsigned bits[kSlotsPerThread] = {};
#pragma unroll
    for (int i = 0; i < kGroupsPerWord; ++i) {
      const int g = g0 + i * splits;
      if (g < i_hi) test_group(load_group<false>(buf, 4 * g, 0, 0), 4 * i, h, bits);
    }
    add_bits(buf, bits, [g0, splits](int b) { return 4 * (g0 + (b >> 2) * splits) + (b & 3); },
             acc);
  }
}

// The deposit of the tile whose slots start at `slot0` over the stages
// first, first + every, ... of the intervals of `src`: emit(s, (cnt, flux
// rgb)) for each slot s < tile, from the threads of split 0.
template <class Src, class Emit>
__device__ __forceinline__ void deposit_slots_over(const Src& src, long long slot0, int tile,
                                                   int splits,
                                                   const float* __restrict__ packed,
                                                   const float* __restrict__ dep,
                                                   long long dp, int first, int every,
                                                   Emit emit) {
  float* ring = reinterpret_cast<float*>(stage_smem);
  const int q_threads = blockDim.x / splits;
  const int q = threadIdx.x % q_threads, p = threadIdx.x / q_threads;

  HitSlot h[kSlotsPerThread];
  Acc acc;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int s = q + k * q_threads;
    // A slot beyond the tile takes r2 = -1 and a zero normal: it never passes.
    h[k] = s < tile ? load_slot(packed + (slot0 + s) * 8) : HitSlot{0, 0, 0, 0, 0, 0, -1.0f};
    acc.cnt[k] = acc.f0[k] = acc.f1[k] = acc.f2[k] = 0.0f;
  }

  const bool vec = (dp & 3) == 0 && (reinterpret_cast<uintptr_t>(dep) & 15) == 0;
  StageIter<Src> it(src);
  int index = 0;
  Stage cur, nxt;
  bool have = it.next_own(cur, index, first, every);
  if (have) copy_stage(ring, cur, dep, dp, vec);
  int b = 0;
  while (have) {
    cp_async_wait_all();
    __syncthreads();      // stage landed everywhere; the other buffer is free
    const bool more = it.next_own(nxt, index, first, every);
    if (more) copy_stage(ring + (b ^ 1) * kRows * kStageLanes, nxt, dep, dp, vec);
    test_stage(ring + b * kRows * kStageLanes, cur, p, splits, h, acc);
    cur = nxt;
    have = more;
    b ^= 1;
  }

  // Add the splits' partial sums in split order, through shared memory.
  float4* part = stage_smem;                                // [splits - 1][tile]
  __syncthreads();
  if (p > 0) {
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      const int s = q + k * q_threads;
      if (s < tile)
        part[(p - 1) * tile + s] = make_float4(acc.cnt[k], acc.f0[k], acc.f1[k], acc.f2[k]);
    }
  }
  __syncthreads();
  if (p > 0) return;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int s = q + k * q_threads;
    if (s >= tile) continue;
    for (int pp = 1; pp < splits; ++pp) {
      const float4 e = part[(pp - 1) * tile + s];
      acc.cnt[k] += e.x;
      acc.f0[k] += e.y;
      acc.f1[k] += e.z;
      acc.f2[k] += e.w;
    }
    emit(s, make_float4(acc.cnt[k], acc.f0[k], acc.f1[k], acc.f2[k]));
  }
}

// This grid split's share of the deposit of one tile (blockIdx.x) over the
// intervals of `src`, into scratch[blockIdx.y]: see the top of this file.
template <class Src>
__device__ __forceinline__ void deposit_tile_over(const Src& src, int tile, int splits,
                                                  const float* __restrict__ packed,
                                                  const float* __restrict__ dep,
                                                  long long dp,
                                                  float4* __restrict__ scratch,
                                                  long long c_pad) {
  const long long slot0 = (long long)blockIdx.x * tile;
  float4* dst = scratch + blockIdx.y * c_pad + slot0;
  deposit_slots_over(src, slot0, tile, splits, packed, dep, dp, blockIdx.y, gridDim.y,
                     [dst](int s, const float4& v) { dst[s] = v; });
}

// Runs of work items cut into parts of at most `per_block` items, one block
// a part (the lane deposit and its transpose): a run of n items has
// max(1, ceil(n / per_block)) parts (an empty run one, which writes its
// zeros).  part_end[r] is the cumulative part count through run r; block j
// takes part j - (part_end[r] - parts) of run r = part_run[j].  A run of one
// part writes its result straight to the output, a run of several writes
// each part's partial sums to scratch[j] and a second kernel adds them in
// part order.
__host__ __device__ inline int parts_of(int lo, int hi, int per_block) {
  return hi - lo > per_block ? (hi - lo + per_block - 1) / per_block : 1;
}

constexpr int kPlanThreads = 1024;

// Plans the parts of runs [lo[r], hi[r]) in one block of kPlanThreads:
// part_end (n_runs) by a block-wide scan of the part counts, part_run
// (n_parts) the run of each part, the spare entries past the last part
// n_runs (ops/lane_kernel.py: run_parts is its plain version).  The launch
// takes n_parts = parts_bound(n_runs, per_block, n_items) blocks, which no
// plan of a list of n_items exceeds.
__host__ __device__ inline long long parts_bound(int n_runs, int per_block, int n_items) {
  return n_runs + ((long long)n_items + per_block - 1) / per_block;
}

__global__ void __launch_bounds__(kPlanThreads)
plan_parts(const int* __restrict__ lo, const int* __restrict__ hi, int n_runs, int per_block,
           int n_parts, int* __restrict__ part_end, int* __restrict__ part_run) {
  __shared__ int warp_sum[kPlanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = 0;                            // parts of the runs before this round
  for (int base = 0; base < n_runs; base += kPlanThreads) {
    const int r = base + t;
    const int v = r < n_runs ? parts_of(lo[r], hi[r], per_block) : 0;
    int incl = v;                           // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {                        // scan of the warps' sums
      int w = warp_sum[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += x;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int end = carry + incl + (warp > 0 ? warp_sum[warp - 1] : 0);
    if (r < n_runs) {
      part_end[r] = end;
      for (int j = end - v; j < min(end, n_parts); ++j) part_run[j] = r;
    }
    carry += warp_sum[kPlanThreads / 32 - 1];
    __syncthreads();                        // warp_sum is rewritten next round
  }
  for (int j = carry + t; j < n_parts; j += kPlanThreads) part_run[j] = n_runs;
}

// out[i] = sum over grid splits g (in order) of scratch[g][i], cols 4:8 zero.
__global__ void combine_partials(const float4* __restrict__ scratch, int gsplits,
                                 long long c_pad, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c_pad) return;
  float4 sum = scratch[i];
  for (int g = 1; g < gsplits; ++g) {
    const float4 v = scratch[g * c_pad + i];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  store_row(out + i * 8, sum.x, sum.y, sum.z, sum.w);
}

// Whether (threads, splits, gsplits, smem) is the launch geometry these
// constants give a tile of `tile` slots (ops/deposit_kernel.py:
// deposit_geometry): every slot one thread's within each split, the staging
// ring and the splits' partial sums in `smem`.
inline bool geometry_fits(int tile, int threads, int splits, int gsplits, int smem) {
  if (tile < 1 || tile > kMaxTile || splits < 1 || gsplits < 1) return false;
  const int q = (tile + kSlotsPerThread - 1) / kSlotsPerThread;
  const int ring = kRing * kRows * kStageLanes * (int)sizeof(float);
  const int partial_sums = (splits - 1) * tile * (int)sizeof(float4);
  return threads == q * splits && threads <= kMaxThreads && smem >= ring &&
         smem >= partial_sums && smem <= kMaxSharedBytes;
}

// Launches `kernel` over (n_tiles, gsplits) blocks of `threads` with
// `smem` bytes of dynamic shared memory, then combine_partials over the
// gsplits planes of `scratch` into `out`; returns the first CUDA error, or
// cudaErrorInvalidValue for a geometry that geometry_fits refuses.
template <class Kernel, class... Args>
int launch_deposit(Kernel kernel, int n_tiles, int tile, int threads, int splits,
                   int gsplits, int smem, long long c_pad, float* out, const float4* scratch,
                   cudaStream_t stream, Args... args) {
  if (!geometry_fits(tile, threads, splits, gsplits, smem)) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(n_tiles, gsplits), threads, smem, stream>>>(args...);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int t = 256;
  combine_partials<<<(unsigned)((c_pad + t - 1) / t), t, 0, stream>>>(scratch, gsplits,
                                                                      c_pad, out);
  return (int)cudaGetLastError();
}

}  // namespace rt3
