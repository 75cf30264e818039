// Ray x bicubic-Bezier-patch Newton solve, the winner contract
// (t, u, v, patch_id, hit) per ray.
//
// Replaces raytrace3_tpu/ops/newton_pallas.py:_newton_kernel (driven by
// make_newton_pallas).  What it computes is the TPU kernel's, exactly:
//   * one lane per (patch, restart); `restarts` is the TOTAL count, laid out
//     as the gu x gv cell-centre grid of _uv0_rows (8 -> 2 x 4);
//   * lanes come in groups of 128 = (128 / restarts) patches x restarts;
//   * a per-lane patch-AABB slab gate, folded into acceptance;
//   * t0 = (S(u0, v0) - o) . d, NOT divided by |d|^2;
//   * `iters` Newton steps, Cramer solve of [d | -Su | -Sv], clamped updates;
//     a root is accepted when res^2 < eps, u, v in [0, 1], t > 1e-4 and t
//     beats the lane's best;
//   * inside a group the min-t winner takes the smallest u, v and patch id
//     among the lanes tied at that t (each independently), and across groups
//     only a strictly smaller t replaces the running winner.
//
// Design on Hopper.  The TPU folded the winner across patch groups by
// revisiting its output block on the sequential grid axis; GPU blocks run in
// no order, so the whole reduction lives inside one block: one block of 128
// threads per ray walks the groups in order (the loop takes the place of the
// sequential grid axis), each thread one lane; the group's winner is a warp
// shuffle reduction plus a 4-entry shared-memory combine.  The control
// points (B x 48 floats, 6 KB for the teapot) sit in shared memory; the
// lane's AABB is recomputed from them.  A lane whose box test fails skips
// its Newton loop (it could never accept).
//
// Bound: fp32 arithmetic (~3K flops per lane at 10 iterations, no memory
// traffic beyond 24 bytes per ray in and 17 out).  Built with -fmad=false and
// without fast math, so every operation rounds like the plain PyTorch
// version in raytrace3_tpu_torch/ops/newton_kernel.py and the slab test keeps
// IEEE 1/0 = inf; clamps and min/max propagate NaN like jnp.clip/minimum.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 128;
constexpr float kBig = 1e9f;
constexpr float kEps = 1e-4f;

struct Winner {
  float t, u, v, p;
};

// NaN-propagating clamp (jnp.clip / torch.clamp); fminf/fmaxf drop NaN.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// Smaller t wins; on a tie the smallest u, v and patch id, independently.
// Associative and commutative, so any reduction order gives the flat result.
__device__ __forceinline__ Winner better(Winner a, Winner b) {
  if (a.t < b.t) return a;
  if (b.t < a.t) return b;
  return {a.t, fminf(a.u, b.u), fminf(a.v, b.v), fminf(a.p, b.p)};
}

__device__ __forceinline__ void bern(float t, float b[4]) {
  const float s = 1.0f - t;
  b[0] = s * s * s;
  b[1] = 3.0f * t * s * s;
  b[2] = 3.0f * t * t * s;
  b[3] = t * t * t;
}

__device__ __forceinline__ void dbern(float t, float b[4]) {
  const float s = 1.0f - t;
  b[0] = -3.0f * s * s;
  b[1] = 3.0f * s * s - 6.0f * t * s;
  b[2] = 6.0f * t * s - 3.0f * t * t;
  b[3] = 3.0f * t * t;
}

// S(u, v) and optionally dS/du, dS/dv; g = ctrl[patch] as [i][k][c], i pairs
// with the v basis and k with the u basis.  Summation order as in the TPU
// kernel's patch_eval.
template <bool kDerivs>
__device__ __forceinline__ void patch_eval(const float* g, float u, float v,
                                           float s[3], float su[3],
                                           float sv[3]) {
  float bu[4], bv[4], du[4], dv[4];
  bern(u, bu);
  bern(v, bv);
  if (kDerivs) {
    dbern(u, du);
    dbern(v, dv);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f, accu = 0.0f, accv = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rowu = 0.0f, rowdu = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float gik = g[(i * 4 + k) * 3 + c];
        rowu = rowu + bu[k] * gik;
        if (kDerivs) rowdu = rowdu + du[k] * gik;
      }
      acc = acc + bv[i] * rowu;
      if (kDerivs) {
        accu = accu + bv[i] * rowdu;
        accv = accv + dv[i] * rowu;
      }
    }
    s[c] = acc;
    if (kDerivs) {
      su[c] = accu;
      sv[c] = accv;
    }
  }
}

__global__ void __launch_bounds__(kLanes)
newton_kernel(const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ ctrl, int n_patches, int restarts,
              int gu, int gv, int iters, float res2_eps,
              float* __restrict__ t_out, float* __restrict__ u_out,
              float* __restrict__ v_out, int* __restrict__ pid_out,
              bool* __restrict__ hit_out) {
  extern __shared__ float sh_ctrl[];            // n_patches * 48
  __shared__ Winner warp_best[kLanes / 32];

  const int ray = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < n_patches * 48; i += kLanes) sh_ctrl[i] = ctrl[i];
  __syncthreads();

  const float ox = org[3 * ray + 0], oy = org[3 * ray + 1], oz = org[3 * ray + 2];
  const float dx = dir[3 * ray + 0], dy = dir[3 * ray + 1], dz = dir[3 * ray + 2];
  const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;

  // This lane's start: restart r of the gu x gv cell-centre grid, computed in
  // double and rounded once, like numpy's float64 grid cast to float32.
  const int r = lane % restarts;
  const float u0 = (float)(((double)(r / gv) + 0.5) / (double)gu);
  const float v0 = (float)(((double)(r % gv) + 0.5) / (double)gv);

  const int per_group = kLanes / restarts;
  const int n_groups = (n_patches + per_group - 1) / per_group;
  Winner cur = {kBig, 0.0f, 0.0f, 0.0f};

  for (int grp = 0; grp < n_groups; ++grp) {
    const int p = grp * per_group + lane / restarts;
    Winner mine = {kBig, 0.0f, 0.0f, (float)p};
    if (p < n_patches) {
      const float* g = sh_ctrl + p * 48;
      float lo[3] = {g[0], g[1], g[2]}, hi[3] = {g[0], g[1], g[2]};
      for (int q = 1; q < 16; ++q) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lo[c] = fminf(lo[c], g[q * 3 + c]);
          hi[c] = fmaxf(hi[c], g[q * 3 + c]);
        }
      }
      // Slab test; a NaN slab (0 * inf) opens the slab, as in the TPU kernel.
      const float t0x = (lo[0] - ox) * inv_x, t1x = (hi[0] - ox) * inv_x;
      const float t0y = (lo[1] - oy) * inv_y, t1y = (hi[1] - oy) * inv_y;
      const float t0z = (lo[2] - oz) * inv_z, t1z = (hi[2] - oz) * inv_z;
      const bool nx = isnan(t0x) || isnan(t1x);
      const bool ny = isnan(t0y) || isnan(t1y);
      const bool nz = isnan(t0z) || isnan(t1z);
      const float tnear = fmaxf(fmaxf(nx ? -kBig : fminf(t0x, t1x),
                                      ny ? -kBig : fminf(t0y, t1y)),
                                nz ? -kBig : fminf(t0z, t1z));
      const float tfar = fminf(fminf(nx ? kBig : fmaxf(t0x, t1x),
                                     ny ? kBig : fmaxf(t0y, t1y)),
                               nz ? kBig : fmaxf(t0z, t1z));
      if (tfar >= fmaxf(tnear, 0.0f)) {
        float s[3], su[3], sv[3];
        float u = u0, v = v0;
        patch_eval<false>(g, u, v, s, su, sv);
        float t = (s[0] - ox) * dx + (s[1] - oy) * dy + (s[2] - oz) * dz;
        float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
        for (int it = 0; it < iters; ++it) {
          patch_eval<true>(g, u, v, s, su, sv);
          const float rx = ox + t * dx - s[0];
          const float ry = oy + t * dy - s[1];
          const float rz = oz + t * dz - s[2];
          const float cx = su[1] * sv[2] - su[2] * sv[1];
          const float cy = su[2] * sv[0] - su[0] * sv[2];
          const float cz = su[0] * sv[1] - su[1] * sv[0];
          const float det = dx * cx + dy * cy + dz * cz;
          const bool ok = fabsf(det) > 1e-12f;
          const float inv_det = 1.0f / (ok ? det : 1.0f);
          const float dt = -(rx * cx + ry * cy + rz * cz) * inv_det;
          const float ex = ry * sv[2] - rz * sv[1];
          const float ey = rz * sv[0] - rx * sv[2];
          const float ez = rx * sv[1] - ry * sv[0];
          const float du = (dx * ex + dy * ey + dz * ez) * inv_det;
          const float fx = su[1] * rz - su[2] * ry;
          const float fy = su[2] * rx - su[0] * rz;
          const float fz = su[0] * ry - su[1] * rx;
          const float dv = (dx * fx + dy * fy + dz * fz) * inv_det;
          const float okf = ok ? 1.0f : 0.0f;
          t = clip(t + clip(dt, -1e4f, 1e4f) * okf, -1e4f, 1e4f);
          u = clip(u + clip(du, -8.0f, 8.0f) * okf, -8.0f, 8.0f);
          v = clip(v + clip(dv, -8.0f, 8.0f) * okf, -8.0f, 8.0f);

          patch_eval<false>(g, u, v, s, su, sv);
          const float ax = ox + t * dx - s[0];
          const float ay = oy + t * dy - s[1];
          const float az = oz + t * dz - s[2];
          const float res2 = ax * ax + ay * ay + az * az;
          if (res2 < res2_eps && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
              v <= 1.0f && t > kEps && t < best_t) {
            best_t = t;
            best_u = u;
            best_v = v;
          }
        }
        mine.t = best_t;
        mine.u = best_u;
        mine.v = best_v;
      }
    }
    // The group's winner: warp shuffles, then the four warps in order.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Winner o;
      o.t = __shfl_xor_sync(0xffffffffu, mine.t, off);
      o.u = __shfl_xor_sync(0xffffffffu, mine.u, off);
      o.v = __shfl_xor_sync(0xffffffffu, mine.v, off);
      o.p = __shfl_xor_sync(0xffffffffu, mine.p, off);
      mine = better(mine, o);
    }
    if ((lane & 31) == 0) warp_best[lane >> 5] = mine;
    __syncthreads();
    if (lane == 0) {
      Winner w = warp_best[0];
      for (int k = 1; k < kLanes / 32; ++k) w = better(w, warp_best[k]);
      if (w.t < cur.t) cur = w;      // strict improvement across groups
    }
    __syncthreads();
  }

  if (lane == 0) {
    t_out[ray] = cur.t;
    u_out[ray] = cur.u;
    v_out[ray] = cur.v;
    pid_out[ray] = min(max((int)cur.p, 0), n_patches - 1);
    hit_out[ray] = cur.t < kBig * 0.5f;
  }
}

}  // namespace

extern "C" int rt3_newton_solve(const float* org, const float* dir,
                                const float* ctrl, int n_rays, int n_patches,
                                int restarts, int gu, int gv, int iters,
                                float res2_eps, float* t, float* u, float* v,
                                int* pid, bool* hit, void* stream) {
  const size_t smem = (size_t)n_patches * 48 * sizeof(float);
  newton_kernel<<<n_rays, kLanes, smem, (cudaStream_t)stream>>>(
      org, dir, ctrl, n_patches, restarts, gu, gv, iters, res2_eps, t, u, v,
      pid, hit);
  return (int)cudaGetLastError();
}
