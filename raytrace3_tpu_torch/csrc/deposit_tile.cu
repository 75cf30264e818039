// Banded photon deposit, one step per hit-point tile: count and raw RGB flux
// of every deposit within each hit point's radius.
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
// overflow: every lane of every interval is visited.
//
// Design on Hopper.  One block per tile, one thread per hit slot (blockDim =
// tile); the block walks its K intervals in order, staging kStage deposit
// lanes (rows 0-8 only) at a time in shared memory with coalesced loads, and
// every thread tests its hit point against the staged lanes, accumulating in
// registers.  Tiles own disjoint output rows, so no atomics.  The TPU-only
// parts do not carry over: the 128-aligned DMA fetch with its lane mask, the
// Dp - chunk clip and the flattened scalar-prefetch operands.  The staging
// width kStage = 512 (18 KB of shared memory) is this kernel's own choice;
// the TPU's chunk 2048 was a DMA tuning.
//
// Bound: the pair tests, ~16 fp32 operations each over the candidate volume
// (all lanes of the tile's K windows x tile), read from shared memory by
// broadcast.  Built with -fmad=false; d2 is summed in the plain version's
// order, (dx*dx + dy*dy) + dz*dz, so the count matches the plain PyTorch
// version in raytrace3_tpu_torch/ops/deposit_kernel.py exactly and the flux
// up to fp32 summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kStage = 512;
constexpr float kNormalDotMin = 1e-3f;

__global__ void deposit_tile_kernel(const int* __restrict__ sk,
                                    const int* __restrict__ ek, int n_windows,
                                    const float* __restrict__ packed,
                                    const float* __restrict__ dep, long long dp,
                                    float* __restrict__ out) {
  __shared__ float sd[9][kStage];

  const int tile = blockIdx.x;
  const long long slot = (long long)tile * blockDim.x + threadIdx.x;
  const float* h = packed + slot * 8;
  const float hx = h[0], hy = h[1], hz = h[2];
  const float nx = h[3], ny = h[4], nz = h[5];
  const float r2 = h[6];

  float cnt = 0.0f, f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
  for (int k = 0; k < n_windows; ++k) {
    // Clipped to the deposit array, so no interval reads outside it.
    const int s = max(sk[tile * n_windows + k], 0);
    const int e = (int)min((long long)ek[tile * n_windows + k], dp);
    for (int base = s; base < e; base += kStage) {
      const int n = min(kStage, e - base);
      __syncthreads();                      // the previous stage is consumed
      for (int i = threadIdx.x; i < 9 * kStage; i += blockDim.x) {
        const int row = i / kStage, col = i % kStage;
        if (col < n) sd[row][col] = dep[row * dp + base + col];
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float dx = hx - sd[0][j];
        const float dy = hy - sd[1][j];
        const float dz = hz - sd[2][j];
        const float d2 = (dx * dx + dy * dy) + dz * dz;
        const float ndot = (nx * sd[3][j] + ny * sd[4][j]) + nz * sd[5][j];
        if (d2 <= r2 && ndot > kNormalDotMin) {
          cnt += 1.0f;
          f0 += sd[6][j];
          f1 += sd[7][j];
          f2 += sd[8][j];
        }
      }
    }
  }
  float* o = out + slot * 8;
  o[0] = cnt;
  o[1] = f0;
  o[2] = f1;
  o[3] = f2;
  o[4] = 0.0f;
  o[5] = 0.0f;
  o[6] = 0.0f;
  o[7] = 0.0f;
}

}  // namespace

extern "C" int rt3_deposit_tile(const int* sk, const int* ek, int n_tiles,
                                int n_windows, int tile, const float* packed,
                                const float* dep, long long dp, float* out,
                                void* stream) {
  deposit_tile_kernel<<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
      sk, ek, n_windows, packed, dep, dp, out);
  return (int)cudaGetLastError();
}
