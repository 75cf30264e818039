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
//   wa, wb     (W',) int32: its lane mask [wa, wb), inside its chunk;
//   packed     (c_pad, 8) f32: hit slot pos xyz, n xyz, r2, pad;
//   u          (c_pad, 3) f32: the hit slot's cotangent row wgt g_tao / pi;
//   dep        (16, Dp) f32: key-sorted deposits, Dp = n_blocks * ch;
//   out        (3, Dp) f32: d_flux per sorted lane (the host unsorts).
//
// Design on Hopper.  The TPU walks the chunk-sorted items in order and
// flushes a chunk's accumulator when the chunk changes; here one block per
// chunk (blockDim = ch, one thread per deposit lane) walks its own run, so
// blocks own disjoint output lanes and need no atomics: the result does not
// depend on the order blocks run in.  Per item the block stages the tile's
// hit rows (7 floats each) and cotangent rows (3 each) in shared memory, 10
// floats x tile (10 KB at tile 256), and each thread whose lane lies in the
// item's mask tests its deposit against every hit row, accumulating in
// registers.
//
// Bound: the pair tests, 15 fp32 operations each plus 3 adds per pair taken,
// over sum_s (wb - wa) x tile; the threads of a chunk outside an item's mask
// idle through it.  Built with -fmad=false, so the pairs taken are exactly
// the forward's and the plain version's in
// raytrace3_tpu_torch/ops/lane_kernel.py; sums differ in order only.

#include <cuda_runtime.h>

#include "deposit_pair.cuh"

namespace {

__global__ void deposit_lane_bwd_kernel(const int* __restrict__ run_lo,
                                        const int* __restrict__ run_hi,
                                        const int* __restrict__ wt,
                                        const int* __restrict__ wa,
                                        const int* __restrict__ wb, int tile,
                                        const float* __restrict__ packed,
                                        const float* __restrict__ u,
                                        const float* __restrict__ dep,
                                        long long dp, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* sh = sm;                 // (tile, 7): pos xyz, n xyz, r2
  float* su = sm + 7 * tile;      // (tile, 3)

  const int blk = blockIdx.x;
  const long long lane = (long long)blk * blockDim.x + threadIdx.x;
  const float dx = dep[0 * dp + lane], dy = dep[1 * dp + lane];
  const float dz = dep[2 * dp + lane], dnx = dep[3 * dp + lane];
  const float dny = dep[4 * dp + lane], dnz = dep[5 * dp + lane];

  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  const int lo = run_lo[blk], hi = run_hi[blk];
  for (int s = lo; s < hi; ++s) {
    const long long base = (long long)wt[s] * tile;
    __syncthreads();                        // the previous item is consumed
    for (int i = threadIdx.x; i < 7 * tile; i += blockDim.x) {
      sh[i] = packed[(base + i / 7) * 8 + i % 7];
    }
    for (int i = threadIdx.x; i < 3 * tile; i += blockDim.x) {
      su[i] = u[base * 3 + i];
    }
    __syncthreads();
    if (lane < wa[s] || lane >= wb[s]) continue;
    for (int i = 0; i < tile; ++i) {
      const float* r = sh + 7 * i;
      const rt3::HitSlot h{r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
      if (rt3::pair_passes(h, dx, dy, dz, dnx, dny, dnz)) {
        a0 += su[3 * i];
        a1 += su[3 * i + 1];
        a2 += su[3 * i + 2];
      }
    }
  }
  out[0 * dp + lane] = a0;
  out[1 * dp + lane] = a1;
  out[2 * dp + lane] = a2;
}

}  // namespace

extern "C" int rt3_deposit_lane_bwd(const int* run_lo, const int* run_hi,
                                    int n_blocks, int chunk, const int* wt,
                                    const int* wa, const int* wb, int tile,
                                    const float* packed, const float* u,
                                    const float* dep, long long dp, float* out,
                                    void* stream) {
  const size_t smem = sizeof(float) * 10 * (size_t)tile;
  deposit_lane_bwd_kernel<<<n_blocks, chunk, smem, (cudaStream_t)stream>>>(
      run_lo, run_hi, wt, wa, wb, tile, packed, u, dep, dp, out);
  return (int)cudaGetLastError();
}
