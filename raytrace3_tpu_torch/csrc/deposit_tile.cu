// Banded photon deposit, one hit-point tile per CUDA block: count and raw
// RGB flux of every deposit within each hit point's radius.
//
// Replaces raytrace3_tpu/ops/deposit_pallas.py:_tile_loop_kernel (driven by
// PallasDepositTile._kernel_call).  Contract, as there:
//   sk, ek     (n_tiles, K) int32: tile i's K cascaded, disjoint intervals
//              [sk, ek) of the key-sorted deposit lanes;
//   packed     (c_pad, 8) f32: hit slot pos xyz, n xyz, r2, pad (padding
//              slots carry r2 = -1, so nothing passes);
//   dep        (16, Dp) f32: pos xyz, n xyz, flux rgb, zeros (invalid lanes
//              sit at 1e9, so d2 ~ 1e18 stays finite and fails);
//   out        (c_pad, 8) f32: col 0 count, cols 1:4 flux sum, cols 4:8 zero.
// A pair passes when |h - d|^2 <= r2_h and n_h . n_d > 1e-3.  No cap, no
// overflow: every lane of every interval, clipped to [0, Dp), is tested
// against every slot of the tile.
//
// What bounds it on an H100: instruction throughput, not bytes.  The bench round
// (tile 256) reads 9 rows x 1.8 M lanes once (66 MB, 0.02 ms at 3.35 TB/s)
// and tests 2.6 G pairs.  A pair test is 15 fp32 instructions (8 for d2,
// 5 for n . n, 2 compares), and nothing fuses: every source builds with
// -fmad=false, which keeps the counts equal to the plain twin's.  The
// bound in chip_smoke.py counts those 15 operations against 67 TFLOP/s,
// a rate that counts an FMA as two, so one instruction a pair runs at
// half of it: the instruction floor is twice the bound.
//
// The first version (one thread per slot, 6 scalar shared loads and 4
// predicated adds per pair test, plain copies between two barriers a
// stage, one block per tile) ran 24.75 SASS instructions a pair test
// (99 per 4 in its inner loop).  This one (deposit_stage.cuh) runs 16.3
// on the test path (7 FADD, 6 FMUL, 2 FSETP, 0.94 LOP3, 0.38 LDS.128) and
// 17.6 with the per-word count and flux adds counted once (2257 per 128 in
// its word loop, cuobjdump -sass of the sm_90a build):
//   * R = 4 hit slots a thread, so a staged lane serves 4 pair tests;
//   * lanes read as float4 groups of 4 (6 128-bit loads per 16 pairs);
//   * passes gathered as bits, count and flux added per word of 32 lanes,
//     in fp32;
//   * a 2-deep ring of 512-lane stages filled by 16-byte cp.async, one
//     barrier a stage;
//   * 256-thread blocks: ceil(tile / 4) slot threads x `splits` lane
//     splits (4 at tile 256), 2 blocks an SM at 106 registers;
//   * 8 blocks a tile (`gsplits`), each taking every 8th stage of the
//     tile, their sums added in order by combine_partials: the heaviest
//     tile of the bench round holds 16x the mean lanes (118,140 against
//     7,508), and one block a tile left it on the tail.
// On the bench round: 2.262 ms against the first version's 7.402 ms in the
// same run, counts exact, flux 2.5e-7 from the plain twin summed in
// float64 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6,
// scripts/perf_kernels.py).  The TPU-only parts do not carry
// over: the 128-aligned DMA fetch with its lane mask (here a 16-byte-aligned
// copy and zero normals on the head and tail lanes), the Dp - chunk clip
// and the flattened scalar-prefetch operands.

#include <cuda_runtime.h>

#include "deposit_stage.cuh"

namespace {

// Tile i's K windows, clipped to the deposit array.
struct TileWindows {
  const int* __restrict__ sk;
  const int* __restrict__ ek;
  int n_windows;
  long long dp;

  __device__ int count() const { return n_windows; }
  __device__ void get(int k, long long& a, long long& b) const {
    const long long i = (long long)blockIdx.x * n_windows + k;
    a = max(sk[i], 0);
    b = min((long long)ek[i], dp);
  }
};

__global__ void __launch_bounds__(rt3::kMaxThreads, rt3::kMinBlocks)
deposit_tile_kernel(const int* __restrict__ sk, const int* __restrict__ ek, int n_windows,
                    int tile, int splits, const float* __restrict__ packed,
                    const float* __restrict__ dep, long long dp,
                    float4* __restrict__ scratch, long long c_pad) {
  const TileWindows src{sk, ek, n_windows, dp};
  rt3::deposit_tile_over(src, tile, splits, packed, dep, dp, scratch, c_pad);
}

}  // namespace

// threads, splits, gsplits, smem: the launch geometry (deposit_stage.cuh);
// scratch: (gsplits, c_pad, 4) f32 for the grid splits' partial sums.
extern "C" int rt3_deposit_tile(const int* sk, const int* ek, int n_tiles, int n_windows,
                                int tile, const float* packed, const float* dep,
                                long long dp, float* out, int threads, int splits,
                                int gsplits, int smem, float* scratch, void* stream) {
  const long long c_pad = (long long)n_tiles * tile;
  float4* part = reinterpret_cast<float4*>(scratch);
  return rt3::launch_deposit(deposit_tile_kernel, n_tiles, tile, threads, splits, gsplits,
                             smem, c_pad, out, part, (cudaStream_t)stream, sk, ek, n_windows,
                             tile, splits, packed, dep, dp, part, c_pad);
}
