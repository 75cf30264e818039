// Block-granular banded photon deposit over a flat work list: count and raw
// RGB flux of every deposit within each hit point's radius.
//
// Replaces raytrace3_tpu/ops/deposit_pallas.py:_deposit_kernel (driven by
// PallasDeposit._kernel_call), the CLI's --deposit pallas and the deposit
// of the reference1024 preset.  Contract:
//   wt, blk,   (W,) int32 work items sorted by tile: item s adds deposit
//   wcmp       block blk[s] (lanes [blk wchunk, (blk + 1) wchunk), whole,
//              with no lane mask) to tile wt[s] when wcmp[s] != 0; pad
//              items repeat the last real item's tile with wcmp = 0;
//   packed     (c_pad, 8) f32: hit slot pos xyz, n xyz, r2, pad (padding
//              slots carry r2 = -1, so nothing passes);
//   dep        (16, Dp) f32: pos xyz, n xyz, flux rgb, zeros, key-sorted,
//              Dp a multiple of wchunk (invalid lanes sit at 1e9);
//   out        (c_pad, 8) f32: col 0 count, cols 1:4 flux sum, cols 4:8 zero.
// The list holds the first W items only.  A tile whose items straddle W
// keeps its partial sums, and a tile none of whose items made it (its
// first item lies at or beyond W) reads 0: the TPU version's "handled"
// mask (deposit_pallas.py:517-524) falls out of the run bounds.
//
// Design on Hopper.  The TPU walks the items in order on one core and
// flushes a tile's accumulator when the tile changes.  Here one block per
// tile (blockDim = tile, up to 1024 threads, one per hit slot) finds its
// own run [lo, hi) of items by binary search over the sorted wt, so blocks
// own disjoint output rows and need no atomics, and every output row is
// written (the wrapper's torch.empty is safe only because of that).  Per
// computing item the block stages the whole block of wchunk lanes (rows
// 0-8) kStage lanes at a time in shared memory (deposit_pair.cuh, 18 KB) and
// every thread tests its hit point against them, accumulating in registers.
// __launch_bounds__(1024) holds the kernel to 64 registers a thread so that
// a 1024-slot tile launches.
//
// Bound: the pair tests, 15 fp32 operations each plus 4 adds per pair
// taken, over (computing items) x wchunk x tile; bytes are small beside
// them.  Built with -fmad=false, so counts match the plain PyTorch version
// in raytrace3_tpu_torch/ops/deposit_kernel.py exactly and flux up to fp32
// summation order.

#include <cuda_runtime.h>

#include "deposit_pair.cuh"

namespace {

constexpr int kStage = 512;
constexpr int kMaxTile = 1024;

// First index in the sorted wt[0, n) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ wt, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (wt[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kMaxTile)
deposit_block_kernel(const int* __restrict__ wt, const int* __restrict__ blk,
                     const int* __restrict__ wcmp, int n_items, int wchunk,
                     const float* __restrict__ packed,
                     const float* __restrict__ dep, long long dp,
                     float* __restrict__ out) {
  __shared__ float sd[9][kStage];

  const int tile = blockIdx.x;
  const long long slot = (long long)tile * blockDim.x + threadIdx.x;
  const rt3::HitSlot h = rt3::load_slot(packed + slot * 8);

  float cnt = 0.0f, f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
  const int lo = lower_bound(wt, n_items, tile);
  const int hi = lower_bound(wt, n_items, tile + 1);
  for (int s = lo; s < hi; ++s) {
    if (wcmp[s] == 0) continue;              // the same for every thread
    const long long a = (long long)max(blk[s], 0) * wchunk;
    const long long b = min(a + wchunk, dp);
    if (a >= b) continue;
    rt3::accumulate_lanes<kStage>(sd, dep, dp, (int)a, (int)b, h, cnt, f0, f1, f2);
  }
  rt3::store_row(out + slot * 8, cnt, f0, f1, f2);
}

}  // namespace

extern "C" int rt3_deposit_block(const int* wt, const int* blk, const int* wcmp,
                                 int n_items, int wchunk, int n_tiles, int tile,
                                 const float* packed, const float* dep,
                                 long long dp, float* out, void* stream) {
  deposit_block_kernel<<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
      wt, blk, wcmp, n_items, wchunk, packed, dep, dp, out);
  return (int)cudaGetLastError();
}
