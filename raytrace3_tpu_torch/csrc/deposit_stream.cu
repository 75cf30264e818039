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
// Design on Hopper.  One block per tile (blockDim = tile, up to 1024
// threads, one per hit slot) walks its run in order; blocks own disjoint
// output rows, so no atomics, and every row is written.  Per item the block
// decodes the mask and stages only the masked lanes [wa, wb) (rows 0-8,
// kStage lanes at a time, deposit_pair.cuh), so the 128-aligned fetch
// survives only as the base of the mask.  The TPU kernel keeps nbuf - 1
// DMA fetches in flight in a ring of VMEM buffers; this kernel has no
// counterpart of that ring yet: each item's lanes are staged after the
// previous item's are consumed.
//
// Bound: the pair tests, 15 fp32 operations each plus 4 adds per pair
// taken, over sum_j (wb - wa) x tile.  Built with -fmad=false, so counts
// match the plain PyTorch version in raytrace3_tpu_torch/ops/lane_kernel.py
// exactly and flux up to fp32 summation order.

#include <cuda_runtime.h>

#include "deposit_pair.cuh"

namespace {

constexpr int kStage = 512;
constexpr int kMaxTile = 1024;

__global__ void __launch_bounds__(kMaxTile)
deposit_stream_kernel(const int* __restrict__ itf, const int* __restrict__ itab,
                      const int* __restrict__ starts, const int* __restrict__ ends,
                      const float* __restrict__ packed,
                      const float* __restrict__ dep, long long dp,
                      float* __restrict__ out) {
  __shared__ float sd[9][kStage];

  const int tile = blockIdx.x;
  const long long slot = (long long)tile * blockDim.x + threadIdx.x;
  const rt3::HitSlot h = rt3::load_slot(packed + slot * 8);

  float cnt = 0.0f, f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
  const int j0 = starts[tile], j1 = ends[tile];
  for (int j = j0; j < j1; ++j) {
    const long long f = itf[j];
    const int ab = itab[j];
    const long long a = max(f + (ab >> 16), 0LL);
    const long long b = min(f + (ab & 0xFFFF), dp);
    if (a >= b) continue;                    // the same for every thread
    rt3::accumulate_lanes<kStage>(sd, dep, dp, (int)a, (int)b, h, cnt, f0, f1, f2);
  }
  rt3::store_row(out + slot * 8, cnt, f0, f1, f2);
}

}  // namespace

extern "C" int rt3_deposit_stream(const int* itf, const int* itab, const int* starts,
                                  const int* ends, int n_tiles, int tile,
                                  const float* packed, const float* dep,
                                  long long dp, float* out, void* stream) {
  deposit_stream_kernel<<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
      itf, itab, starts, ends, packed, dep, dp, out);
  return (int)cudaGetLastError();
}
