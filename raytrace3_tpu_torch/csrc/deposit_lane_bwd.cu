// Transpose of the lane-granular deposit: per deposit lane j,
// d_flux[j] = sum_i m_ij u_i over the same masked pair tests.
//
// Replaces raytrace3_tpu/ops/deposit_pallas.py:_lane_bwd_kernel (driven by
// PallasDepositLane._backward_flux), the backward of the gradient path.
// Contract:
//   run_lo,    (n_blocks,) int32: deposit chunk b (lanes [b*ch, (b+1)*ch))
//   run_hi     takes items [run_lo[b], run_hi[b]) of the list sorted by
//              chunk; a chunk with an empty run reads 0;
//   wt         (W',) int32: the item's hit-point tile;
//   wa, wb     (W',) int32: its lane mask [wa, wb), inside its chunk (clipped
//              to it here);
//   packed     (c_pad, 8) f32: hit slot pos xyz, n xyz, r2, pad;
//   u          (c_pad, 3) f32: the hit slot's cotangent row wgt g_tao / pi;
//   dep        (16, Dp) f32: key-sorted deposits, Dp = n_blocks * ch;
//   out        (3, Dp) f32: d_flux per sorted lane (the host unsorts).
//
// What bounds it on an H100: instruction throughput, the pair tests (15
// fp32 operations each, 3 adds a pair taken) over sum_s (wb - wa) x tile;
// under -fmad=false the instruction floor is twice chip_smoke.py's bound.
//
// Design on Hopper.  The TPU walks the chunk-sorted items in order and
// flushes a chunk's accumulator when the chunk changes.  Here a chunk's run
// is cut into parts of at most per_block items (ops/lane_kernel.py:
// LANE_BWD_ITEMS_PER_BLOCK; deposit_stage.cuh: plan_parts), one block a
// part: on the train round a chunk has 8.8 items on average and the
// heaviest 276, so one block a chunk would leave that chunk's items to one
// block.  A chunk of one part writes its lanes straight to out; the parts of
// a longer run write their lane sums to scratch, and combine_parts adds them
// in part order: no atomics, so the result is the same bit for bit from run
// to run.  The first version ran one thread a lane of the chunk and one item
// at a time, so on the train round, where an item masks 69 of 512 lanes on
// average and 58% of items fewer than 32, most of the block idled through
// every item.  Here a block tests all of its part's items at once:
//   * the part's tiles (tile x 32 bytes of packed rows, tile x 12 of u,
//     each one contiguous run) are copied with 16-byte cp.async into shared
//     memory, beside the chunk's deposit lanes (pos, normal);
//   * the items' masked lanes, L in all, are laid end to end, and threads
//     map onto (slot group g, lane q): G = T / L groups (at most tile and
//     kBwdMaxGroups; one when L > T, each thread then taking lanes q, q + T,
//     ...), and virtual thread v = g L + q tests its lane against its item
//     tile's hit rows g, g + G, ...; a hit row is two broadcast 128-bit
//     shared loads;
//   * a thread's passing rows set bits of a 32-bit word, one per row (pairs
//     pass rarely), and only the set bits' cotangent rows are added, in row
//     order, into the thread's partial sums in shared memory;
//   * after one barrier each lane of the chunk adds its partial sums, items
//     in order and groups in order.
// Measured on the train round (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// section 6): 0.225 ms at 3 items a part, against 0.249 for a version that
// tested a part's items one at a time through a 2-deep ring, one barrier an
// item, and 2.40 for the first version.
//
// No tensor cores: m_ij is a distance-and-normal test whose decisions must
// equal the plain version's exactly under -fmad=false (ops/cuda_build.py); a
// |h|^2 - 2 h.d + |d|^2 product in TF32 or bf16 would change them (and the
// port forbids TF32), and the product's N is 3.  The pairs taken are exactly
// the forward's and the plain version's
// (raytrace3_tpu_torch/ops/lane_kernel.py); sums differ in order only.
//
// Launch geometry (ops/lane_kernel.py:lane_bwd_geometry computes it;
// rt3_deposit_lane_bwd refuses any other): T = chunk rounded up to a warp,
// one block a part of at most per_block items, and
// bwd_shared_bytes(tile, chunk, per_block) of dynamic shared memory (opted in
// above 48 KB).

#include <cuda_runtime.h>

#include <cstdint>

#include "deposit_stage.cuh"

namespace {

// ops/lane_kernel.py holds the same values (LANE_BWD_MAX_TILE, ...); a CPU
// test reads them back from this file.
constexpr int kBwdMaxTile = 1024;
constexpr int kBwdMaxChunk = 1024;
constexpr int kBwdMaxThreads = 1024;
constexpr int kBwdMaxItems = 8;             // items a part at most
constexpr int kBwdMaxSharedBytes = 232448;  // an H100 block's opt-in limit
constexpr int kBwdMaxGroups = 16;           // slot groups at most
constexpr int kWordRows = 32;               // rows of one pass-bit word
constexpr int kPartsUnroll = 8;             // parts a combine step loads at once

// Floats of one staged tile: its packed rows, then its u rows padded to whole
// float4s.
__host__ __device__ inline int tile_floats(int tile) {
  return tile * 8 + ((tile * 3 + 3) & ~3);
}

__host__ __device__ inline int bwd_threads(int chunk) { return (chunk + 31) / 32 * 32; }

// Stride of the partial sums: one a virtual thread, at most max(T, L).
__host__ __device__ inline int partial_stride(int chunk, int per_block) {
  return max(bwd_threads(chunk), per_block * chunk);
}

// Dynamic shared memory: the part's tiles, the partial sums (3 strides) and
// the chunk's deposit lanes (6 x chunk).
inline long long bwd_shared_bytes(int tile, int chunk, int per_block) {
  return (long long)sizeof(float) * ((long long)per_block * tile_floats(tile) +
                                     3LL * partial_stride(chunk, per_block) + 6LL * chunk);
}

inline bool bwd_geometry_fits(int tile, int chunk, int per_block, int threads, int smem) {
  if (tile < 1 || tile > kBwdMaxTile || chunk < 1 || chunk > kBwdMaxChunk) return false;
  if (per_block < 1 || per_block > kBwdMaxItems) return false;
  return threads == bwd_threads(chunk) && threads <= kBwdMaxThreads &&
         smem == bwd_shared_bytes(tile, chunk, per_block) && smem <= kBwdMaxSharedBytes;
}

// Copies a tile (packed rows and u rows from row0) into `buf`; commits one
// cp.async group.
__device__ __forceinline__ void copy_tile(float* buf, long long row0, int tile,
                                          const float* __restrict__ packed,
                                          const float* __restrict__ u, bool vec_p,
                                          bool vec_u) {
  const int t = threadIdx.x, nt = blockDim.x;
  const float* ps = packed + row0 * 8;
  if (vec_p) {
    for (int i = t; i < tile * 2; i += nt) rt3::cp_async16(buf + 4 * i, ps + 4 * i);
  } else {
    for (int i = t; i < tile * 8; i += nt) rt3::cp_async4(buf + i, ps + i);
  }
  float* us = buf + tile * 8;
  const float* uu = u + row0 * 3;
  if (vec_u) {
    for (int i = t; i < tile * 3 / 4; i += nt) rt3::cp_async16(us + 4 * i, uu + 4 * i);
  } else {
    for (int i = t; i < tile * 3; i += nt) rt3::cp_async4(us + i, uu + i);
  }
  rt3::cp_async_commit();
}

struct Lane {
  float x, y, z, nx, ny, nz;
};

// The pass bits of rows r0, r0 + G, ... (kWordRows of them, or m < kWordRows
// on the tail) against lane d.
template <bool kTail>
__device__ __forceinline__ unsigned test_word(const float4* __restrict__ rows, int r0, int G,
                                              int m, const Lane& d) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kWordRows; ++i) {
    if (kTail && i >= m) break;
    const int r = r0 + i * G;
    const float4 p = rows[2 * r], q = rows[2 * r + 1];
    const rt3::HitSlot h{p.x, p.y, p.z, p.w, q.x, q.y, q.z};
    if (rt3::pair_passes(h, d.x, d.y, d.z, d.nx, d.ny, d.nz)) bits |= 1u << i;
  }
  return bits;
}

__global__ void __launch_bounds__(kBwdMaxThreads)
deposit_lane_bwd_kernel(const int* __restrict__ run_lo, const int* __restrict__ run_hi,
                        const int* __restrict__ part_run, const int* __restrict__ part_end,
                        int n_blocks, int per_block, const int* __restrict__ wt,
                        const int* __restrict__ wa, const int* __restrict__ wb, int tile,
                        int chunk, const float* __restrict__ packed,
                        const float* __restrict__ u, const float* __restrict__ dep,
                        long long dp, float* __restrict__ out, float* __restrict__ scratch) {
  __shared__ int item_a[kBwdMaxItems], item_n[kBwdMaxItems];  // mask start in the chunk, lanes
  float* sm = reinterpret_cast<float*>(rt3::stage_smem);
  const int nt = blockDim.x, t = threadIdx.x;
  const int tf = tile_floats(tile), ps = partial_stride(chunk, per_block);
  float* tiles = sm;                        // [per_block][tf]
  float* part = tiles + per_block * tf;     // [3][ps]
  float* lanes = part + 3 * ps;             // [6][chunk]

  const int jb = blockIdx.x;
  const int b = part_run[jb];
  if (b >= n_blocks) return;                // a spare block: the list has fewer parts
  const int lo = run_lo[b];
  const int parts = rt3::parts_of(lo, run_hi[b], per_block);
  const int first = lo + (jb - (part_end[b] - parts)) * per_block;
  const int m = min(first + per_block, run_hi[b]) - first;
  const long long cb = (long long)b * chunk;
  // Lane i of component c: out[c][cb + i], or scratch[jb][c][i] for a part.
  float* dst = parts == 1 ? out + cb : scratch + (long long)jb * 3 * chunk;
  const long long stride = parts == 1 ? dp : chunk;
  if (m <= 0) {                             // no item: the chunk reads 0
    for (int i = t; i < 3 * chunk; i += nt) dst[(i / chunk) * stride + i % chunk] = 0.0f;
    return;
  }

  const bool vec_p = (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  const bool vec_u = (tile & 3) == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0;
  for (int i = 0; i < m; ++i) {
    copy_tile(tiles + i * tf, (long long)wt[first + i] * tile, tile, packed, u, vec_p, vec_u);
  }
  if (t < m) {
    const long long a = max((long long)wa[first + t], cb);
    const long long e = min((long long)wb[first + t], cb + chunk);
    item_a[t] = (int)(a - cb);
    item_n[t] = (int)max(e - a, 0LL);
  }
  for (int i = t; i < 6 * chunk; i += nt) lanes[i] = dep[(i / chunk) * dp + cb + i % chunk];
  rt3::cp_async_wait_all();
  __syncthreads();

  int L = 0;
  for (int i = 0; i < m; ++i) L += item_n[i];
  const int G = L > 0 ? max(1, min(min(nt / L, tile), kBwdMaxGroups)) : 0;
  for (int v = t; v < G * L; v += nt) {
    const int g = v / L;
    int q = v - g * L, i = 0;
    while (q >= item_n[i]) q -= item_n[i++];  // the item of lane q
    const int j = item_a[i] + q;
    const Lane d{lanes[j],         lanes[chunk + j],     lanes[2 * chunk + j],
                 lanes[3 * chunk + j], lanes[4 * chunk + j], lanes[5 * chunk + j]};
    const float* tb = tiles + i * tf;
    const float4* rows = reinterpret_cast<const float4*>(tb);
    const float* us = tb + tile * 8;
    const int K = (tile - g + G - 1) / G;    // rows g, g + G, ... below tile
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kWordRows) {
      const int r0 = g + k0 * G;
      unsigned bits = K - k0 >= kWordRows ? test_word<false>(rows, r0, G, kWordRows, d)
                                          : test_word<true>(rows, r0, G, K - k0, d);
      while (bits) {
        const int r = r0 + (__ffs(bits) - 1) * G;
        s0 += us[3 * r];
        s1 += us[3 * r + 1];
        s2 += us[3 * r + 2];
        bits &= bits - 1;
      }
    }
    part[v] = s0;
    part[ps + v] = s1;
    part[2 * ps + v] = s2;
  }
  __syncthreads();

  // Each lane of the chunk: its partial sums, items in order, groups in order.
  for (int j = t; j < chunk; j += nt) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int i = 0, off = 0; i < m; off += item_n[i++]) {
      const int q = j - item_a[i];
      if (q < 0 || q >= item_n[i]) continue;
      for (int g = 0; g < G; ++g) {
        const int v = g * L + off + q;
        s0 += part[v];
        s1 += part[ps + v];
        s2 += part[2 * ps + v];
      }
    }
    dst[j] = s0;
    dst[stride + j] = s1;
    dst[2 * stride + j] = s2;
  }
}

// Chunk blockIdx.x's out lanes = the sums of its parts in part order, for a
// chunk of several parts (a chunk of one wrote its lanes).
__global__ void combine_parts(const float* __restrict__ scratch,
                              const int* __restrict__ run_lo, const int* __restrict__ run_hi,
                              const int* __restrict__ part_end, int per_block, int chunk,
                              long long dp, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int parts = rt3::parts_of(run_lo[b], run_hi[b], per_block);
  if (parts == 1) return;
  const float* p0 = scratch + (long long)(part_end[b] - parts) * 3 * chunk;
  const long long stride = 3LL * chunk;
  for (int i = threadIdx.x; i < 3 * chunk; i += blockDim.x) {
    float s = 0.0f;
    for (int p = 0; p < parts; p += kPartsUnroll) {   // loads in flight together,
      float v[kPartsUnroll];                          // added in part order
#pragma unroll
      for (int k = 0; k < kPartsUnroll; ++k) v[k] = p + k < parts ? p0[(p + k) * stride + i] : 0.0f;
#pragma unroll
      for (int k = 0; k < kPartsUnroll; ++k) s += v[k];
    }
    out[(i / chunk) * dp + (long long)b * chunk + i % chunk] = s;
  }
}

}  // namespace

// threads, smem: the launch geometry (see the top of this file); scratch:
// (n_parts, 3, chunk) f32 for the parts' lane sums; part_run (n_parts,),
// part_end (n_blocks,) int32: filled with the plan of the parts
// (deposit_stage.cuh: plan_parts), n_parts = parts_bound(n_blocks,
// per_block, n_items); n_items: W', the work list's length; per_block: the
// most items a part.  Returns the first CUDA
// error, or cudaErrorInvalidValue for a geometry that bwd_geometry_fits
// refuses or a Dp that is not n_blocks chunks.
extern "C" int rt3_deposit_lane_bwd(const int* run_lo, const int* run_hi, int n_blocks,
                                    int chunk, const int* wt, const int* wa, const int* wb,
                                    int tile, const float* packed, const float* u,
                                    const float* dep, long long dp, float* out, int threads,
                                    int smem, float* scratch, int* part_run, int* part_end,
                                    int n_parts, int n_items, int per_block, void* stream) {
  if (!bwd_geometry_fits(tile, chunk, per_block, threads, smem) || n_blocks < 1 ||
      n_items < 0 || n_parts != rt3::parts_bound(n_blocks, per_block, n_items) ||
      (long long)n_blocks * chunk != dp) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {                   // above the default needs the opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        deposit_lane_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  rt3::plan_parts<<<1, rt3::kPlanThreads, 0, st>>>(run_lo, run_hi, n_blocks, per_block, n_parts,
                                                   part_end, part_run);
  deposit_lane_bwd_kernel<<<n_parts, threads, smem, st>>>(run_lo, run_hi, part_run, part_end,
                                                          n_blocks, per_block, wt, wa, wb,
                                                          tile, chunk, packed, u, dep, dp,
                                                          out, scratch);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_parts<<<n_blocks, 256, 0, st>>>(scratch, run_lo, run_hi, part_end, per_block, chunk,
                                          dp, out);
  return (int)cudaGetLastError();
}
