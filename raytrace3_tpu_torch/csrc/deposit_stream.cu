// Item-stream banded photon deposit: count and raw RGB flux of every
// deposit within each hit point's radius, each tile walking its own run of
// precomputed, lane-masked work items.
//
// Replaces raytrace3_tpu/ops/deposit_pallas.py:_stream_kernel (driven by
// PallasDepositStream._kernel_call).  Contract:
//   itf, itab  (W,) int32: item j fetches from lane itf[j] (128-aligned on
//              the TPU) and counts lanes [itf + (itab >> 16),
//              itf + (itab & 0xFFFF)), the lane mask packed in two 16-bit
//              fields by the host;
//   starts,    (n_tiles,) int32: tile i's run of items [starts[i], ends[i]),
//   ends       cut at the work cap by the host, so a tile straddling it
//              keeps its partial sums and one beyond it reads 0;
//   packed     (c_pad, 8) f32: hit slot pos xyz, n xyz, r2, pad;
//   dep        (16, Dp) f32: pos xyz, n xyz, flux rgb, zeros, key-sorted;
//   out        (c_pad, 8) f32: col 0 count, cols 1:4 flux sum, cols 4:8 zero.
//
// What bounds it on an H100: instruction throughput, as for the tile and
// block deposits: the bench round in tiles of 128 tests 2.485 G pairs over
// 21,775 items; under -fmad=false the instruction floor is twice
// chip_smoke.py's bound.
//
// Design (deposit_stage.cuh, as deposit_tile.cu and deposit_block.cu): a
// stream item is one lane interval, its mask decoded here and clipped to
// [0, Dp), so the 128-aligned fetch survives only as the base of the mask.
// Each tile's items come straight from its run [starts, ends), with no
// search.  From the header: 4 hit slots a thread, float4 groups of lanes,
// pass bits, the 2-deep cp.async ring of 512-lane stages (the counterpart of
// the TPU kernel's nbuf-deep DMA ring, with its depth fixed there), 256-
// thread blocks and 8 blocks a tile whose sums combine_partials adds in
// order.  The first version ran one block a tile, one thread a hit slot, and
// staged each item's lanes with plain copies between two barriers a stage,
// six scalar shared loads serving one pair test.  Counts equal the plain
// PyTorch version's (raytrace3_tpu_torch/ops/lane_kernel.py) exactly; flux
// differs by fp32 summation order.  On the bench round: 2.390 ms against the
// first version's 7.129 ms in the same run (device times), counts exact,
// flux 2.4e-7 from the plain twin summed in float64 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md section 6, scripts/perf_kernels.py).

#include <cuda_runtime.h>

#include "deposit_stage.cuh"

namespace {

// Tile blockIdx.x's items, each its decoded mask clipped to the deposit array.
struct StreamItems {
  const int* __restrict__ itf;
  const int* __restrict__ itab;
  int lo, hi;
  long long dp;

  __device__ int count() const { return hi - lo; }
  __device__ void get(int i, long long& a, long long& b) const {
    const long long f = itf[lo + i];
    const int ab = itab[lo + i];
    a = max(f + (ab >> 16), 0LL);
    b = min(f + (ab & 0xFFFF), dp);
  }
};

__global__ void __launch_bounds__(rt3::kMaxThreads, rt3::kMinBlocks)
deposit_stream_kernel(const int* __restrict__ itf, const int* __restrict__ itab,
                      const int* __restrict__ starts, const int* __restrict__ ends, int tile,
                      int splits, const float* __restrict__ packed,
                      const float* __restrict__ dep, long long dp,
                      float4* __restrict__ scratch, long long c_pad) {
  const int t = blockIdx.x;
  const StreamItems src{itf, itab, starts[t], ends[t], dp};
  rt3::deposit_tile_over(src, tile, splits, packed, dep, dp, scratch, c_pad);
}

}  // namespace

// threads, splits, gsplits, smem: the launch geometry (deposit_stage.cuh);
// scratch: (gsplits, c_pad, 4) f32 for the grid splits' partial sums.
extern "C" int rt3_deposit_stream(const int* itf, const int* itab, const int* starts,
                                  const int* ends, int n_tiles, int tile,
                                  const float* packed, const float* dep, long long dp,
                                  float* out, int threads, int splits, int gsplits, int smem,
                                  float* scratch, void* stream) {
  const long long c_pad = (long long)n_tiles * tile;
  float4* part = reinterpret_cast<float4*>(scratch);
  return rt3::launch_deposit(deposit_stream_kernel, n_tiles, tile, threads, splits, gsplits,
                             smem, c_pad, out, part, (cudaStream_t)stream, itf, itab, starts,
                             ends, tile, splits, packed, dep, dp, part, c_pad);
}
