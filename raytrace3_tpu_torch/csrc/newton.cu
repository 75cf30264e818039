// Ray x bicubic-Bezier-patch Newton solve, the winner contract
// (t, u, v, patch_id, hit) per ray.
//
// Replaces raytrace3_tpu/ops/newton_pallas.py:_newton_kernel (driven by
// make_newton_pallas).  What it computes is the TPU kernel's, exactly:
//   * one lane per (patch, restart); `restarts` is the TOTAL count, laid out
//     as the gu x gv cell-centre grid of _uv0_rows (8 -> 2 x 4);
//   * lanes come in groups of 128 = (128 / restarts) patches x restarts;
//   * a patch-AABB slab gate, folded into acceptance;
//   * t0 = (S(u0, v0) - o) . d, NOT divided by |d|^2;
//   * `iters` Newton steps, Cramer solve of [d | -Su | -Sv], clamped updates;
//     a root is accepted when res^2 < eps, u, v in [0, 1], t > 1e-4 and t
//     beats the lane's best;
//   * inside a group the min-t winner takes the smallest u, v and patch id
//     among the lanes tied at that t (each independently), and across groups
//     only a strictly smaller t replaces the running winner.
//
// What bounds it on an H100.  Not bytes (24 in and 17 out a ray) and not the
// card's arithmetic rate: few lanes open their patch box (~0.6% of the
// (ray, patch) pairs of a photon segment), and an open lane runs a chain of
// ~10 dependent Newton steps.  The first version (one 128-thread block a ray,
// walking the patch groups in order) paid a fixed cost a ray for its single
// ray: a copy of all control points, every lane's box recomputed from 16
// control points, two barriers and a serial combine a group, and warps that
// ran Newton on 8 of 32 lanes while the block's other warps waited.
//
// Design.  A block of kThreads threads takes kRaysPerBlock rays (8, the
// fastest of 2 to 128 on the render pass's calls: larger blocks leave the
// open pairs of a few heavy blocks to run in series, smaller ones fill
// fewer lanes a warp):
//   * once a block: the control points go to shared memory (an odd stride,
//     so lanes on different patches read different banks) and the B patch
//     boxes are built, one thread a patch, as the TPU kernel's table is;
//   * once a ray: its three reciprocals, by IEEE division;
//   * once a (ray, patch) pair, one thread each: the slab test, in the first
//     version's operation order and NaN rules;
//   * the open pairs go to a shared queue (warp ballots, then each warp's
//     offset from the warps' counts, so the order is fixed); the queue is
//     drained kThreads / restarts pairs at a time, one thread a (pair,
//     restart) lane, which runs the first version's per-lane arithmetic on
//     control points held in registers: its (best_t, best_u, best_v) is
//     bit-identical to the first version's.  A block none of whose pairs
//     opens runs no Newton; the queue drains whenever one more gate round
//     might overflow it, so a ray inside every box is no special case;
//   * an order-free winner: each accepted lane is the state (t, g, u, v, p),
//     g = p / (128 / restarts) its group.  A smaller t wins, on equal t the
//     smaller g, on equal (t, g) the minimum of u, of v and of p, each on its
//     own.  The combine is associative and commutative and equals the
//     sequential fold above (the first group reaching the least t, and inside
//     it the tied lanes' minima), so lanes may drain in any order.  In shared
//     memory: an atomicMin of the key (t bits, g) (t > 0, so its bits order
//     like its value), then atomicMins of u, v (order-preserving bits) and p
//     over the lanes holding the least key, then one thread a ray folds the
//     drain step into the ray's winner.  A ray with no accepted lane writes
//     (BIG, 0, 0, pid 0, hit false); accepted t are clipped to +-1e4 < BIG.
// Built with -fmad=false and without fast math, so every operation rounds
// like the plain PyTorch version in raytrace3_tpu_torch/ops/newton_kernel.py
// and the slab test keeps IEEE 1/0 = inf.  The Newton arithmetic contracts
// multiply-adds where XLA's CPU code does (the reference's rounding, fault
// F2 of ROADMAP section 3), with explicit __fmaf_rn, which the twin rounds
// the same way (fma32); clamps and min/max propagate NaN
// like jnp.clip/minimum.  The launch refuses, with cudaErrorInvalidValue, a
// shape it cannot take.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; device times; PERF.md section 6,
// scripts/perf_kernels.py): 0.0127 ms against the first version's 0.0539 ms
// on a photon segment's 6553 rays, 0.0697 ms against 0.2797 ms on a render
// pass's largest call (23,592 rays), outputs bit-identical.  What holds it
// now is one lane's chain of Newton steps: on the photon segment 83 of 820
// blocks have an open pair, each runs one drain step, and the kernel takes
// about the time of that step.

#include <cuda_runtime.h>
#include <math.h>

#include <climits>

namespace {

// ops/newton_kernel.py holds the same values (THREADS, RAYS_PER_BLOCK, ...);
// a CPU test reads them back from this file.
constexpr int kThreads = 256;
constexpr int kRaysPerBlock = 8;
constexpr int kGroupLanes = 128;     // the TPU kernel's lane group: the tie rules' unit
constexpr int kMaxPatches = 256;     // a queue entry packs the patch in 8 bits
constexpr int kQueue = 1024;         // open pairs a block holds before it drains
constexpr int kCtrlStride = 49;      // floats a patch's control points take in shared memory
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e9f;
constexpr float kEps = 1e-4f;
constexpr unsigned long long kNoKey = ~0ull;
static_assert(kQueue >= 2 * kThreads, "a drain must leave room for a gate round");
static_assert(kRaysPerBlock <= kThreads, "one thread a ray writes the winners");
static_assert(kThreads % kGroupLanes == 0, "a drain step holds whole lane groups");

// A ray as the gate and the Newton lanes read it.
struct RayRow {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// NaN-propagating clamp (jnp.clip / torch.clamp); fminf/fmaxf drop NaN.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// A float's bits, mapped so that unsigned order is float order (u and v of
// tied lanes are combined by atomicMin), and back.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ void bern(float t, float b[4]) {
  const float s = 1.0f - t;
  b[0] = s * s * s;
  b[1] = 3.0f * t * s * s;
  b[2] = 3.0f * t * t * s;
  b[3] = t * t * t;
}

// dB/dt.  (6 t) s is shared by the two middle terms and (3 t) t by the third
// and the last, so XLA's CPU code contracts only the second term's (3 s) s.
__device__ __forceinline__ void dbern(float t, float b[4]) {
  const float s = 1.0f - t;
  const float ts6 = 6.0f * t * s, tt3 = 3.0f * t * t;
  b[0] = -3.0f * s * s;
  b[1] = __fmaf_rn(3.0f * s, s, -ts6);
  b[2] = ts6 - tt3;
  b[3] = tt3;
}

// a0 b0 + a1 b1 + a2 b2 (+ a3 b3) from the left, each product contracted into
// the add that takes it, as XLA's CPU code sums them: fma(a0, b0, a1 b1), then
// fma(ak, bk, sum) (ops/newton_kernel.py:_dot).
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a0, b0, a1 * b1));
}

__device__ __forceinline__ float dot4(const float (&a)[4], const float (&b)[4]) {
  return __fmaf_rn(a[3], b[3], __fmaf_rn(a[2], b[2], __fmaf_rn(a[0], b[0], a[1] * b[1])));
}

// a b - c d as XLA's CPU code contracts it (ops/newton_kernel.py:_cross).
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

// S(u, v) and optionally dS/du, dS/dv; g = ctrl[patch] as [i][k][c], i pairs
// with the v basis and k with the u basis.  Summation order and contraction
// as in ops/newton_kernel.py:_patch_eval.
template <bool kDerivs>
__device__ __forceinline__ void patch_eval(const float (&g)[48], float u, float v,
                                           float s[3], float su[3], float sv[3]) {
  float bu[4], bv[4], du[4], dv[4];
  bern(u, bu);
  bern(v, bv);
  if (kDerivs) {
    dbern(u, du);
    dbern(v, dv);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rowu[4], rowdu[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gi[4] = {g[(i * 4) * 3 + c], g[(i * 4 + 1) * 3 + c], g[(i * 4 + 2) * 3 + c],
                           g[(i * 4 + 3) * 3 + c]};
      rowu[i] = dot4(bu, gi);
      if (kDerivs) rowdu[i] = dot4(du, gi);
    }
    s[c] = dot4(bv, rowu);
    if (kDerivs) {
      su[c] = dot4(bv, rowdu);
      sv[c] = dot4(dv, rowu);
    }
  }
}

// The slab test of ray `r` against patch p's box (rows lo xyz, hi xyz of
// `box`, each B wide); a NaN slab (0 * inf) opens the slab, as in the TPU
// kernel.
__device__ __forceinline__ bool box_open(const RayRow& r, const float* box, int B, int p) {
  const float t0x = (box[p] - r.ox) * r.ix, t1x = (box[3 * B + p] - r.ox) * r.ix;
  const float t0y = (box[B + p] - r.oy) * r.iy, t1y = (box[4 * B + p] - r.oy) * r.iy;
  const float t0z = (box[2 * B + p] - r.oz) * r.iz, t1z = (box[5 * B + p] - r.oz) * r.iz;
  const bool nx = isnan(t0x) || isnan(t1x);
  const bool ny = isnan(t0y) || isnan(t1y);
  const bool nz = isnan(t0z) || isnan(t1z);
  const float tnear = fmaxf(fmaxf(nx ? -kBig : fminf(t0x, t1x), ny ? -kBig : fminf(t0y, t1y)),
                            nz ? -kBig : fminf(t0z, t1z));
  const float tfar = fminf(fminf(nx ? kBig : fmaxf(t0x, t1x), ny ? kBig : fmaxf(t0y, t1y)),
                           nz ? kBig : fmaxf(t0z, t1z));
  return tfar >= fmaxf(tnear, 0.0f);
}

// One (ray, patch, restart) lane from (u0, v0): the lane's best accepted root
// (best_t = kBig if none).
__device__ __forceinline__ void newton_lane(const float* __restrict__ gs, const RayRow& ray,
                                            float u0, float v0, int iters, float res2_eps,
                                            float& best_t, float& best_u, float& best_v) {
  float g[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) g[i] = gs[i];
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  float s[3], su[3], sv[3];
  float u = u0, v = v0;
  patch_eval<false>(g, u, v, s, su, sv);
  float t = dot3(s[0] - ox, dx, s[1] - oy, dy, s[2] - oz, dz);
  best_t = kBig;
  best_u = 0.0f;
  best_v = 0.0f;
  for (int it = 0; it < iters; ++it) {
    patch_eval<true>(g, u, v, s, su, sv);
    const float rx = __fmaf_rn(t, dx, ox) - s[0];
    const float ry = __fmaf_rn(t, dy, oy) - s[1];
    const float rz = __fmaf_rn(t, dz, oz) - s[2];
    const float cx = cross_term(su[1], sv[2], su[2], sv[1]);
    const float cy = cross_term(su[2], sv[0], su[0], sv[2]);
    const float cz = cross_term(su[0], sv[1], su[1], sv[0]);
    const float det = dot3(dx, cx, dy, cy, dz, cz);
    const bool ok = fabsf(det) > 1e-12f;
    const float inv_det = 1.0f / (ok ? det : 1.0f);
    const float dt = -dot3(rx, cx, ry, cy, rz, cz) * inv_det;
    const float ex = cross_term(ry, sv[2], rz, sv[1]);
    const float ey = cross_term(rz, sv[0], rx, sv[2]);
    const float ez = cross_term(rx, sv[1], ry, sv[0]);
    const float du = dot3(dx, ex, dy, ey, dz, ez) * inv_det;
    const float fx = cross_term(su[1], rz, su[2], ry);
    const float fy = cross_term(su[2], rx, su[0], rz);
    const float fz = cross_term(su[0], ry, su[1], rx);
    const float dv = dot3(dx, fx, dy, fy, dz, fz) * inv_det;
    const float okf = ok ? 1.0f : 0.0f;
    t = clip(t + clip(dt, -1e4f, 1e4f) * okf, -1e4f, 1e4f);
    u = clip(u + clip(du, -8.0f, 8.0f) * okf, -8.0f, 8.0f);
    v = clip(v + clip(dv, -8.0f, 8.0f) * okf, -8.0f, 8.0f);

    patch_eval<false>(g, u, v, s, su, sv);
    const float ax = __fmaf_rn(t, dx, ox) - s[0];
    const float ay = __fmaf_rn(t, dy, oy) - s[1];
    const float az = __fmaf_rn(t, dz, oz) - s[2];
    const float res2 = dot3(ax, ax, ay, ay, az, az);
    if (res2 < res2_eps && u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f && t > kEps &&
        t < best_t) {
      best_t = t;
      best_u = u;
      best_v = v;
    }
  }
}

// The block's rays' winners: the running winner (w_*) and the current drain
// step's (s_*), one entry a ray.
struct Winners {
  unsigned long long wkey[kRaysPerBlock], skey[kRaysPerBlock];
  unsigned wu[kRaysPerBlock], wv[kRaysPerBlock], su[kRaysPerBlock], sv[kRaysPerBlock];
  int wp[kRaysPerBlock], sp[kRaysPerBlock];
};

__device__ __forceinline__ void clear_step(Winners& w, int r) {
  w.skey[r] = kNoKey;
  w.su[r] = w.sv[r] = ~0u;
  w.sp[r] = INT_MAX;
}

// Runs the queue's first qn pairs, kThreads / restarts pairs a step, and
// folds their lanes into the winners.  Every thread of the block calls it
// with the same qn; it begins and ends with a barrier.
__device__ __forceinline__ void drain(const int* __restrict__ queue, int qn,
                                      const float* __restrict__ ctrl_s,
                                      const RayRow* __restrict__ rays, Winners& w, int n_local,
                                      int restarts, float u0, float v0, int iters,
                                      float res2_eps) {
  const int tid = threadIdx.x;
  const int per_step = kThreads / restarts;
  const int per_group = kGroupLanes / restarts;
  const int slot = tid / restarts;
  __syncthreads();                          // the queue's entries are written
  for (int q0 = 0; q0 < qn; q0 += per_step) {
    const int q = q0 + slot;
    bool acc = false;
    float bt = kBig, bu = 0.0f, bv = 0.0f;
    int r = 0, p = 0;
    if (q < qn) {
      const int e = queue[q];
      r = e >> 8;
      p = e & 255;
      newton_lane(ctrl_s + p * kCtrlStride, rays[r], u0, v0, iters, res2_eps, bt, bu, bv);
      acc = bt < kBig;
    }
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(bt) << 32) | (unsigned)(p / per_group);
    if (acc) atomicMin(&w.skey[r], key);
    __syncthreads();
    if (acc && key == w.skey[r]) {
      atomicMin(&w.su[r], ordered(bu));
      atomicMin(&w.sv[r], ordered(bv));
      atomicMin(&w.sp[r], p);
    }
    __syncthreads();
    if (tid < n_local && w.skey[tid] != kNoKey) {     // fold this step into the winner
      const unsigned long long k = w.skey[tid];
      if (k < w.wkey[tid]) {
        w.wkey[tid] = k;
        w.wu[tid] = w.su[tid];
        w.wv[tid] = w.sv[tid];
        w.wp[tid] = w.sp[tid];
      } else if (k == w.wkey[tid]) {
        w.wu[tid] = min(w.wu[tid], w.su[tid]);
        w.wv[tid] = min(w.wv[tid], w.sv[tid]);
        w.wp[tid] = min(w.wp[tid], w.sp[tid]);
      }
      clear_step(w, tid);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
newton_kernel(const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ ctrl, int n_rays, int n_patches, int restarts,
              int gu, int gv, int iters, float res2_eps, float* __restrict__ t_out,
              float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ pid_out,
              bool* __restrict__ hit_out) {
  extern __shared__ float dyn[];            // ctrl (B x kCtrlStride), then boxes (6 x B)
  __shared__ RayRow rays[kRaysPerBlock];
  __shared__ int queue[kQueue];
  __shared__ int warp_open[2][kWarps];      // per gate round (double-buffered)
  __shared__ Winners w;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = n_patches;
  const int ray0 = blockIdx.x * kRaysPerBlock;
  const int n_local = min(kRaysPerBlock, n_rays - ray0);
  float* ctrl_s = dyn;
  float* box = dyn + B * kCtrlStride;

  for (int i = tid; i < B * 48; i += kThreads) ctrl_s[(i / 48) * kCtrlStride + i % 48] = ctrl[i];
  if (tid < n_local) {
    const int ray = ray0 + tid;
    RayRow r;
    r.ox = org[3 * ray + 0];
    r.oy = org[3 * ray + 1];
    r.oz = org[3 * ray + 2];
    r.dx = dir[3 * ray + 0];
    r.dy = dir[3 * ray + 1];
    r.dz = dir[3 * ray + 2];
    r.ix = 1.0f / r.dx;
    r.iy = 1.0f / r.dy;
    r.iz = 1.0f / r.dz;
    rays[tid] = r;
    w.wkey[tid] = kNoKey;
    w.wu[tid] = w.wv[tid] = ~0u;
    w.wp[tid] = INT_MAX;
    clear_step(w, tid);
  }
  __syncthreads();
  for (int p = tid; p < B; p += kThreads) {   // the patch boxes, one thread a patch
    const float* g = ctrl_s + p * kCtrlStride;
    float lo[3] = {g[0], g[1], g[2]}, hi[3] = {g[0], g[1], g[2]};
    for (int q = 1; q < 16; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], g[q * 3 + c]);
        hi[c] = fmaxf(hi[c], g[q * 3 + c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      box[c * B + p] = lo[c];
      box[(3 + c) * B + p] = hi[c];
    }
  }
  __syncthreads();

  // This thread's restart when it runs a Newton lane: restart r of the
  // gu x gv cell-centre grid, computed in double and rounded once, like
  // numpy's float64 grid cast to float32.
  const int rs = tid % restarts;
  const float u0 = (float)(((double)(rs / gv) + 0.5) / (double)gu);
  const float v0 = (float)(((double)(rs % gv) + 0.5) / (double)gv);

  // Gate rounds of kThreads (ray, patch) pairs; the open ones join the queue.
  const int n_pairs = n_local * B;
  int qn = 0;                               // the same in every thread
  for (int base = 0, round = 0; base < n_pairs; base += kThreads, ++round) {
    const int pair = base + tid;
    bool open = false;
    int entry = 0;
    if (pair < n_pairs) {
      const int r = pair / B, p = pair - r * B;
      open = box_open(rays[r], box, B, p);
      entry = (r << 8) | p;
    }
    const unsigned m = __ballot_sync(0xffffffffu, open);
    int* counts = warp_open[round & 1];
    if (lane == 0) counts[warp] = __popc(m);
    __syncthreads();
    int at = qn, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int c = counts[k];
      at += k < warp ? c : 0;
      total += c;
    }
    if (open) queue[at + __popc(m & ((1u << lane) - 1u))] = entry;
    qn += total;
    if (qn > kQueue - kThreads || (base + kThreads >= n_pairs && qn > 0)) {
      drain(queue, qn, ctrl_s, rays, w, n_local, restarts, u0, v0, iters, res2_eps);
      qn = 0;
    }
  }

  if (tid < n_local) {
    const int ray = ray0 + tid;
    const unsigned long long k = w.wkey[tid];
    const bool any = k != kNoKey;
    const float t = any ? __uint_as_float((unsigned)(k >> 32)) : kBig;
    t_out[ray] = t;
    u_out[ray] = any ? unordered(w.wu[tid]) : 0.0f;
    v_out[ray] = any ? unordered(w.wv[tid]) : 0.0f;
    pid_out[ray] = any ? min(max(w.wp[tid], 0), B - 1) : 0;
    hit_out[ray] = t < kBig * 0.5f;
  }
}

// out = __fmaf_rn(a, b, c) elementwise: the card's fused multiply-add, which
// chip_smoke.py holds the twin's fma32 to.
__global__ void fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const float* __restrict__ c, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fmaf_rn(a[i], b[i], c[i]);
}

}  // namespace

extern "C" int rt3_fma32(const float* a, const float* b, const float* c, float* out, int n,
                         void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  fma_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, c, out, n);
  return (int)cudaGetLastError();
}

// Returns cudaErrorInvalidValue, launching nothing, for a shape the kernel
// cannot take: no patch or more than kMaxPatches, restarts that do not
// divide 128 or a (gu, gv) grid that is not theirs, negative counts.
extern "C" int rt3_newton_solve(const float* org, const float* dir, const float* ctrl,
                                int n_rays, int n_patches, int restarts, int gu, int gv,
                                int iters, float res2_eps, float* t, float* u, float* v,
                                int* pid, bool* hit, void* stream) {
  if (n_rays < 0 || n_patches < 1 || n_patches > kMaxPatches || restarts < 1 ||
      kGroupLanes % restarts != 0 || gu < 1 || gv < 1 || gu * gv != restarts || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return (int)cudaSuccess;
  const int smem = n_patches * (kCtrlStride + 6) * (int)sizeof(float);
  if (smem > 48 * 1024) {                   // above the default needs the opt-in
    const cudaError_t e =
        cudaFuncSetAttribute(newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  newton_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      org, dir, ctrl, n_rays, n_patches, restarts, gu, gv, iters, res2_eps, t, u, v, pid, hit);
  return (int)cudaGetLastError();
}
