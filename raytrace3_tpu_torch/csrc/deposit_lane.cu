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
//              most one chunk of lanes, within [0, Dp);
//   packed     (c_pad, 8) f32: hit slot pos xyz, n xyz, r2, pad (padding
//              slots carry r2 = -1, so nothing passes);
//   dep        (16, Dp) f32: pos xyz, n xyz, flux rgb, zeros, key-sorted;
//   out        (c_pad, 8) f32: col 0 count, cols 1:4 flux sum, cols 4:8 zero.
//
// Design on Hopper.  The TPU walks the items in order on one core and
// flushes a tile's accumulator when the tile changes; here one block per tile
// (blockDim = tile, one thread per hit slot) walks its own run, so blocks
// own disjoint output rows and need no atomics.  Per item the block stages
// the item's masked lanes (rows 0-8, at most kStage = 512 lanes, 18 KB of
// shared memory) with coalesced loads and every thread tests its hit point
// against them, accumulating in registers (deposit_pair.cuh).  The TPU's
// 128-aligned fetch `f` and its lane mask reduce to the interval [wa, wb):
// nothing outside it is read.
//
// Bound: the pair tests, 15 fp32 operations each plus 4 adds per pair taken,
// over sum_s (wb - wa) x tile; bytes are small beside them.  Built with
// -fmad=false, so counts match the plain PyTorch version in
// raytrace3_tpu_torch/ops/lane_kernel.py exactly and flux up to fp32
// summation order.

#include <cuda_runtime.h>

#include "deposit_pair.cuh"

namespace {

constexpr int kStage = 512;

__global__ void deposit_lane_kernel(const int* __restrict__ item_lo,
                                    const int* __restrict__ item_hi,
                                    const int* __restrict__ wa,
                                    const int* __restrict__ wb,
                                    const float* __restrict__ packed,
                                    const float* __restrict__ dep, long long dp,
                                    float* __restrict__ out) {
  __shared__ float sd[9][kStage];

  const int tile = blockIdx.x;
  const long long slot = (long long)tile * blockDim.x + threadIdx.x;
  const rt3::HitSlot h = rt3::load_slot(packed + slot * 8);

  float cnt = 0.0f, f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
  const int lo = item_lo[tile], hi = item_hi[tile];
  for (int s = lo; s < hi; ++s) {
    const int a = max(wa[s], 0);
    const int b = (int)min((long long)wb[s], dp);
    rt3::accumulate_lanes<kStage>(sd, dep, dp, a, b, h, cnt, f0, f1, f2);
  }
  rt3::store_row(out + slot * 8, cnt, f0, f1, f2);
}

}  // namespace

extern "C" int rt3_deposit_lane(const int* item_lo, const int* item_hi,
                                int n_tiles, int tile, const int* wa,
                                const int* wb, const float* packed,
                                const float* dep, long long dp, float* out,
                                void* stream) {
  deposit_lane_kernel<<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
      item_lo, item_hi, wa, wb, packed, dep, dp, out);
  return (int)cudaGetLastError();
}
