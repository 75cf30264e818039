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
// The TPU walks the items in order on one core and flushes a tile's
// accumulator when the tile changes.  Here each block of a tile finds the
// tile's run [lo, hi) of items by binary search over the sorted wt, so
// blocks own disjoint rows of the grid splits' scratch and need no atomics.
// Every block writes its rows, zeros for a tile with no item, and
// combine_partials writes every output row from them (the wrapper's
// torch.empty is safe only because of that).
//
// What bounds it on an H100: instruction throughput, not bytes, as for the tile
// deposit (deposit_tile.cu): the reference1024 round tests 13.2 G pairs
// (12,930 computing items of 1024 lanes x 1024 slots) and moves ~120 MB;
// under -fmad=false the instruction floor is twice chip_smoke.py's bound.
//
// Design (deposit_stage.cuh, as deposit_tile.cu): each computing item is
// one interval of wchunk lanes; R = 4 slots a thread, float4 groups, pass
// bits, fp32 sums, a 2-deep cp.async ring of 512-lane stages, 8 blocks a
// tile.  The first version ran one 1024-thread block a tile at 54
// registers (one block, half the warps, on an SM, stalled whole on each
// stage's plain copies), and walked a tile's items one global load at a
// time: the list's pad items (wcmp = 0, all in the last real item's tile,
// 52,606 of 65,536 at the preset) made that tile's block the tail.  Here a
// block is 256 threads (2 an SM at 111 registers) and trims its run's
// trailing non-computing items in one parallel pass.  SASS per pair test:
// 24.75 before, 16.3 on the test path and 17.6 with the flux adds after.
// On the reference1024 round: 9.721 ms against the first version's 26.386
// ms in the same run, counts exact, flux 1.2e-6 from the plain twin summed
// in float64 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6,
// scripts/perf_kernels.py).

#include <cuda_runtime.h>

#include "deposit_stage.cuh"

namespace {

// First index in the sorted wt[0, n) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ wt, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (wt[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The tile's computing items, each the whole block blk[s] clipped to Dp.
struct TileItems {
  const int* __restrict__ blk;
  const int* __restrict__ wcmp;
  int lo, hi, wchunk;
  long long dp;

  __device__ int count() const { return hi - lo; }
  __device__ void get(int i, long long& a, long long& b) const {
    const int s = lo + i;
    if (wcmp[s] == 0) {                     // tests nothing
      a = b = 0;
      return;
    }
    a = (long long)max(blk[s], 0) * wchunk;
    b = min(a + wchunk, dp);
  }
};

__global__ void __launch_bounds__(rt3::kMaxThreads, rt3::kMinBlocks)
deposit_block_kernel(const int* __restrict__ wt, const int* __restrict__ blk,
                     const int* __restrict__ wcmp, int n_items, int wchunk, int tile,
                     int splits, const float* __restrict__ packed,
                     const float* __restrict__ dep, long long dp,
                     float4* __restrict__ scratch, long long c_pad) {
  const int t = blockIdx.x;
  const int lo = lower_bound(wt, n_items, t);
  // The list's pad items (wcmp = 0, all in the last real item's tile) can
  // outnumber the real ones: drop the run's trailing non-computing items
  // with one parallel pass rather than one dependent load each.
  __shared__ int last;
  if (threadIdx.x == 0) last = lo - 1;
  __syncthreads();
  const int hi = lower_bound(wt, n_items, t + 1);
  for (int s = hi - 1 - (int)threadIdx.x; s > last; s -= blockDim.x) {
    if (wcmp[s] != 0) {
      atomicMax(&last, s);
      break;
    }
  }
  __syncthreads();
  const TileItems src{blk, wcmp, lo, last + 1, wchunk, dp};
  rt3::deposit_tile_over(src, tile, splits, packed, dep, dp, scratch, c_pad);
}

}  // namespace

// threads, splits, gsplits, smem: the launch geometry (deposit_stage.cuh);
// scratch: (gsplits, c_pad, 4) f32 for the grid splits' partial sums.
extern "C" int rt3_deposit_block(const int* wt, const int* blk, const int* wcmp,
                                 int n_items, int wchunk, int n_tiles, int tile,
                                 const float* packed, const float* dep, long long dp,
                                 float* out, int threads, int splits, int gsplits, int smem,
                                 float* scratch, void* stream) {
  const long long c_pad = (long long)n_tiles * tile;
  float4* part = reinterpret_cast<float4*>(scratch);
  return rt3::launch_deposit(deposit_block_kernel, n_tiles, tile, threads, splits, gsplits,
                             smem, c_pad, out, part, (cudaStream_t)stream, wt, blk, wcmp,
                             n_items, wchunk, tile, splits, packed, dep, dp, part, c_pad);
}
