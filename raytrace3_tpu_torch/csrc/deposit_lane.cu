// Lane-granular banded photon deposit over a flat work list: count and raw
// RGB flux of every deposit within each hit point's radius.
//
// Replaces raytrace3_tpu/ops/deposit_pallas.py:_lane_kernel (driven by
// PallasDepositLane._kernel_call), the forward of the gradient path.
// Contract:
//   item_lo,   (n_tiles,) int32: tile i's run of work items
//   item_hi    [item_lo[i], item_hi[i]); the host cuts every run at the
//              work cap W, so items at or beyond W never run, a tile whose
//              items straddle W keeps its partial sums, and a tile with an
//              empty run reads 0 (the TPU version's "handled" mask);
//   wa, wb     (W,) int32: item s counts deposit lanes [wa[s], wb[s]), at
//              most one chunk of lanes, clipped here to [0, Dp);
//   packed     (c_pad, 8) f32: hit slot pos xyz, n xyz, r2, pad (padding
//              slots carry r2 = -1, so nothing passes);
//   dep        (16, Dp) f32: pos xyz, n xyz, flux rgb, zeros, key-sorted;
//   out        (c_pad, 8) f32: col 0 count, cols 1:4 flux sum, cols 4:8 zero.
//
// What bounds it on an H100: instruction throughput, the pair tests (15
// fp32 operations each, 4 adds a pair taken) over sum_s (wb - wa) x tile;
// under -fmad=false the instruction floor is twice chip_smoke.py's bound.
//
// Design (deposit_stage.cuh, as deposit_tile.cu, deposit_block.cu and
// deposit_stream.cu): a work item is one lane interval, so each tile's
// items come straight from its run [item_lo, item_hi) with no search (the
// stream deposit's items with the mask unpacked).  From the header: 4 hit
// slots a thread, float4 groups of lanes, pass bits, the 2-deep cp.async
// ring of 512-lane stages and 256-thread blocks.  The header's split of
// every tile into 8 blocks does not fit this work list.  On the train round
// a tile has 1.9 items of 74 lanes on average, less than one 512-lane stage
// each, while the heaviest has 28 items and 13,303 lanes (2.4% of the
// round).  Eight blocks a tile start 7 blocks with little or nothing to do
// and add 8 planes of partial sums (16 MB each); one block a tile leaves
// the heaviest tile's 28 stages to one block, the kernel's tail.  Measured
// on that round (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): 0.537,
// 0.423, 0.424 and 0.580 ms with 1, 2, 4 and 8 blocks a tile.  So the
// blocks follow the items instead: a tile's run is cut into parts of at
// most per_block items (ops/lane_kernel.py: LANE_ITEMS_PER_BLOCK; planned
// on the card by deposit_stage.cuh: plan_parts), one block a part; a tile
// of one part writes its rows straight to out, the parts of a longer run
// write partial sums that combine_parts adds in part order, so no atomics
// are needed.  Measured the same way: 0.217 ms at 3 items a part (0.25,
// 0.22, 0.23 at 2, 4, 5), against 0.808 for the first version.  The first version ran one block a tile,
// one thread a hit slot, and staged each item's lanes with plain copies
// between two barriers, six scalar shared loads serving one pair test.
// Counts equal the plain PyTorch version's
// (raytrace3_tpu_torch/ops/lane_kernel.py) exactly; flux differs by fp32
// summation order.

#include <cuda_runtime.h>

#include "deposit_stage.cuh"

namespace {

// Items [lo, hi) of the work list, each its mask clipped to the deposit
// array.
struct LaneItems {
  const int* __restrict__ wa;
  const int* __restrict__ wb;
  int lo, hi;
  long long dp;

  __device__ int count() const { return hi - lo; }
  __device__ void get(int i, long long& a, long long& b) const {
    a = max((long long)wa[lo + i], 0LL);
    b = min((long long)wb[lo + i], dp);
  }
};

__global__ void __launch_bounds__(rt3::kMaxThreads, rt3::kMinBlocks)
deposit_lane_kernel(const int* __restrict__ item_lo, const int* __restrict__ item_hi,
                    const int* __restrict__ part_run, const int* __restrict__ part_end,
                    int n_tiles, int per_block, const int* __restrict__ wa,
                    const int* __restrict__ wb, int tile, int splits,
                    const float* __restrict__ packed, const float* __restrict__ dep,
                    long long dp, float* __restrict__ out, float4* __restrict__ scratch) {
  const int j = blockIdx.x;
  const int t = part_run[j];
  if (t >= n_tiles) return;                 // a spare block: the list has fewer parts
  const int lo = item_lo[t], hi = item_hi[t];
  const int parts = rt3::parts_of(lo, hi, per_block);
  const int a = lo + (j - (part_end[t] - parts)) * per_block;
  const LaneItems src{wa, wb, a, min(a + per_block, hi), dp};
  const long long slot0 = (long long)t * tile;
  float* row = out + slot0 * 8;
  float4* part = scratch + (long long)j * tile;
  rt3::deposit_slots_over(src, slot0, tile, splits, packed, dep, dp, 0, 1,
                          [=](int s, const float4& v) {
                            if (parts == 1) {
                              rt3::store_row(row + s * 8, v.x, v.y, v.z, v.w);
                            } else {
                              part[s] = v;
                            }
                          });
}

// Tile blockIdx.x's out rows = the sums of its parts in part order, for a
// tile of several parts (a tile of one wrote its rows).
__global__ void combine_parts(const float4* __restrict__ scratch,
                              const int* __restrict__ item_lo,
                              const int* __restrict__ item_hi,
                              const int* __restrict__ part_end, int per_block, int tile,
                              float* __restrict__ out) {
  const int t = blockIdx.x;
  const int parts = rt3::parts_of(item_lo[t], item_hi[t], per_block);
  if (parts == 1) return;
  const float4* p0 = scratch + (long long)(part_end[t] - parts) * tile;
  constexpr int kUnroll = 4;                // parts whose loads are in flight together
  for (int s = threadIdx.x; s < tile; s += blockDim.x) {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p = 0; p < parts; p += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        v[k] = p + k < parts ? p0[(long long)(p + k) * tile + s] : make_float4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {   // in part order
        sum.x += v[k].x;
        sum.y += v[k].y;
        sum.z += v[k].z;
        sum.w += v[k].w;
      }
    }
    rt3::store_row(out + ((long long)t * tile + s) * 8, sum.x, sum.y, sum.z, sum.w);
  }
}

}  // namespace

// threads, splits, smem: the launch geometry of deposit_stage.cuh with one
// block a part (refused unless geometry_fits takes it with gsplits = 1);
// scratch: (n_parts, tile, 4) f32 for the parts' partial sums; part_run
// (n_parts,), part_end (n_tiles,) int32: filled with the plan of the parts
// (deposit_stage.cuh: plan_parts), n_parts = parts_bound(n_tiles, per_block,
// n_items); n_items: W, the work list's length; per_block: the most items a
// part.
extern "C" int rt3_deposit_lane(const int* item_lo, const int* item_hi, int n_tiles,
                                int tile, const int* wa, const int* wb,
                                const float* packed, const float* dep, long long dp,
                                float* out, int threads, int splits, int smem,
                                float* scratch, int* part_run, int* part_end, int n_parts,
                                int n_items, int per_block, void* stream) {
  if (!rt3::geometry_fits(tile, threads, splits, 1, smem) || per_block < 1 || n_items < 0 ||
      n_parts != rt3::parts_bound(n_tiles, per_block, n_items)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  rt3::plan_parts<<<1, rt3::kPlanThreads, 0, st>>>(item_lo, item_hi, n_tiles, per_block,
                                                   n_parts, part_end, part_run);
  float4* part = reinterpret_cast<float4*>(scratch);
  deposit_lane_kernel<<<n_parts, threads, smem, st>>>(item_lo, item_hi, part_run, part_end,
                                                      n_tiles, per_block, wa, wb, tile,
                                                      splits, packed, dep, dp, out, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_parts<<<n_tiles, 256, 0, st>>>(part, item_lo, item_hi, part_end, per_block, tile,
                                         out);
  return (int)cudaGetLastError();
}
