// One segment of the persistent-lane photon walk (render/photon.py,
// regen_segment) as four kernels around the Newton kernel (csrc/newton.cu),
// which runs between them unchanged:
//
//   rt3_walk_refill  one thread a lane: refill a dead lane from its light
//                    (the drawn z and phi), the nearest plane and sphere hit
//                    (t, object, inside), the Bezier object's box gate that
//                    feeds the compaction, the lane's Bezier row set to "no
//                    root", and each block's counts of refilled and of gated
//                    lanes;
//   rt3_walk_compact the gated rays gathered, in lane order, into Newton's
//                    slots (below); the eye's segment (eye.cu) runs it too;
//   rt3_walk_bezier  one thread a compacted ray: the winner's normal from its
//                    (u, v, patch), written with (t, u, v, hit) into the row
//                    of the lane it came from;
//   rt3_walk_shade   one thread a lane: the Bezier winner merged into the
//                    nearest hit (torch.argmin's first minimum), position,
//                    normal, u/v (with the teapot's u/t quirk), atlas colour,
//                    material, the deposit record, the roulette branch and
//                    its direction, the new flux (debiased on request),
//                    depth and alive; block 0 adds the refills to `emitted`
//                    and the refill offset.
//
// Replaces no TPU kernel.  The JAX package's segment
// (raytrace3_tpu/render/photon.py, regen_segment) is a chain of elementwise
// operators that XLA fuses into a few loops; the port ran it as about 530
// PyTorch launches a segment, each a few microseconds of card time behind
// 12-15 us of host issue, so the card idled through the walk.  These kernels
// issue the segment in 4 launches beside the draws and Newton.
//
// What bounds them on an H100: bytes, and at a segment's size the launch.
// A segment's inputs and outputs are 127 bytes a lane (carry in and out,
// five draws, the record; ops/walk_kernel.segment_bytes) against a few
// hundred float operations, so its least time is those bytes over 3.35
// TB/s: 5.0 us for 131,072 lanes, 40 us for 1,048,576.  The kernels move
// 264 bytes a lane (the refilled lanes, the analytic hit and the Bezier
// row are written by refill and read by shade; walk_kernel.kernel_bytes)
// and 65 a compacted ray.  Design: one thread a lane, lanes in order, each
// reading its own rows; the tables (planes, spheres, materials, the
// atlas) are small, read by every lane and stay in L1/L2, so they count in
// no bound.  The refill count is exact: a block
// count (__syncthreads_count) and a reduction of the block counts in the
// next kernel, with no atomics.
//
// The compaction (rt3_walk_compact) writes what geometry/bezier.solve_gated
// hands Newton, bit for bit: the first `cap` gated lanes in ascending order
// and then fill slots (index n) in `idx`, each slot's ray (a fill slot
// carries lane n - 1's, as clamp_max(idx, n - 1) gathers it), and the whole
// gated count, not capped, for the pass's tally.  It replaces a stable radix
// sort of a 0/1 key and the gathers around it (about 25 host calls a
// segment, the largest host chain left in a segment) by one launch with no
// memset and no host read.  Design: the segment's first kernel writes each block's gated
// count (__syncthreads_count, as the refill count); a compaction block takes
// kCompactLanes lanes, sums the counts of the blocks before its own and of
// all of them, ranks its lanes by warp ballots and popcounts and an
// exclusive scan of the warps' counts, scatters the ranks below `cap`, and
// writes its share of the fill slots.  What bounds it: bytes, a byte a lane
// of gate and 32 a slot written (24 more read a gathered ray), and at a
// segment's size the launch; every block reads all the block counts (4
// bytes a 256 lanes, from L2).
//
// Numerics: built with -fmad=false and without fast math, and written in
// the op path's operation order (render/photon.py, geometry/*.py,
// core/vecmath.py, textures/texture.py), so each product and sum rounds as
// the PyTorch operators round it on the card: dot products from the left,
// a division by a Python scalar as PyTorch's CUDA kernel does it (times the
// float reciprocal), comparisons with float32 constants, NaN-propagating
// min/max and clamps, argmin's first minimum with NaN as the least.  The
// scene's tables, the analytic hits, the box gate and the hit's surface are
// surface.cuh's, shared with the eye's kernels (eye.cu).

#include <cuda_runtime.h>
#include <math.h>

#include "surface.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Lanes a compaction block ranks: kCompactTiles of the first kernel's blocks.
constexpr int kCompactLanes = 2048;
constexpr int kCompactTiles = kCompactLanes / kThreads;
static_assert(kCompactLanes % kThreads == 0 && kCompactTiles * kWarps == 64,
              "the compaction scans 64 warp counts, two a lane of one warp");

}  // namespace

// One segment's lanes: the carry in, the draws, what the kernels hand each
// other, and the carry and record out.
struct WalkLanes {
  const float* o;            // (N, 3) carry in
  const float* d;
  const float* f;
  const bool* alive;         // (N,)
  const int* depth;          // (N,)
  const int* rr_off;         // ()
  const float* emitted;      // (L,)
  const long long* lid;      // (N,) refill light, null when L == 1
  const float* z;            // (N,) draws, in the segment's order
  const float* phi;
  const float* ur;
  const float* u1;
  const float* u2;
  float* o_r;                // (N, 3) refilled lanes; f_r is the record's flux
  float* d_r;
  float* f_r;
  float* t_a;                // (N,) nearest plane or sphere hit
  int* obj_a;
  bool* ins_a;
  bool* gate;                // (N,) Bezier box gate
  float* rows;               // (N, 7) Bezier winner: t, u, v, hit, n
  int* partial;              // (blocks,) refilled lanes a block
  int* gated;                // (blocks,) Bezier-gated lanes a block
  float* pos;                // (N, 3) carry and record out
  float* nrm;
  bool* valid;
  float* nd;
  float* nf;
  bool* alive_out;
  int* depth_out;
  int* rr_off_out;           // ()
  float* emitted_out;        // (L,)
  int n, segs, debias, blocks;
};

namespace {

// core/vecmath.orthonormal_frame (Duff et al.).
__device__ __forceinline__ void frame(V3 n, V3& t1, V3& t2) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -(1.0f / (s + n.z));
  const float b = n.x * n.y * a;
  t1 = {1.0f + s * (n.x * n.x) * a, s * b, -s * n.x};
  t2 = {b, s + (n.y * n.y) * a, -n.y};
}

// core/sampling.cosine_hemisphere.
__device__ __forceinline__ V3 cosine_dir(float u1, float u2, V3 n) {
  const float ct = sqrtf(u1);
  const float st = sqrtf(clamp_min0(1.0f - u1));
  const float ph = u2 * kTwoPi;
  const float a = st * cosf(ph), b = st * sinf(ph);
  V3 t, bt;
  frame(n, t, bt);
  return {t.x * a + bt.x * b + n.x * ct, t.y * a + bt.y * b + n.y * ct,
          t.z * a + bt.z * b + n.z * ct};
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

// One lane of the refill kernel; returns its Bezier box gate.
__device__ __forceinline__ bool refill_lane(const WalkScene& sc, const WalkLanes& w,
                                            const float* s_lohi, int i, bool need) {
  V3 o, d, f;
  if (need) {
    const int l = sc.L == 1 ? 0 : (int)w.lid[i];
    o = ld3(sc.light_pos, l);
    const float z = w.z[i], ph = w.phi[i];
    const float r = sqrtf(clamp_min0(1.0f - z * z));
    d = {r * cosf(ph), r * sinf(ph), z};
    const V3 lc = ld3(sc.light_color, l);
    f = {lc.x * kFourPi, lc.y * kFourPi, lc.z * kFourPi};
  } else {
    o = ld3(w.o, i);
    d = ld3(w.d, i);
    f = ld3(w.f, i);
  }
  st3(w.o_r, i, o);
  st3(w.d_r, i, d);
  st3(w.f_r, i, f);

  float best;
  int obj;
  bool inside;
  analytic_hit(sc, o, d, best, obj, inside);
  w.t_a[i] = best;
  w.obj_a[i] = obj;
  w.ins_a[i] = inside;

  if (sc.B == 0) return false;
  const bool g = box_gate(s_lohi, o, d);
  w.gate[i] = g;
  no_root(w.rows + 7LL * i);
  return g;
}

__global__ void __launch_bounds__(kThreads) refill_kernel(const WalkScene sc, const WalkLanes w) {
  __shared__ float s_box[6][kWarps];
  __shared__ float s_lohi[6];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (sc.B > 0) bezier_box(sc, &s_box[0][0], s_lohi);
  const bool need = i < w.n && !w.alive[i];
  const int refills = __syncthreads_count(need);
  if (threadIdx.x == 0) w.partial[blockIdx.x] = refills;
  const bool g = i < w.n && refill_lane(sc, w, s_lohi, i, need);
  if (sc.B > 0) {
    const int gated = __syncthreads_count(g);
    if (threadIdx.x == 0) w.gated[blockIdx.x] = gated;
  }
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void copy3(const float* src, long long from, float* dst,
                                      long long to) {
  dst[3 * to] = src[3 * from];
  dst[3 * to + 1] = src[3 * from + 1];
  dst[3 * to + 2] = src[3 * from + 2];
}

// geometry/bezier.solve_gated's compaction (see the note above): block b
// ranks lanes [b * kCompactLanes, (b + 1) * kCompactLanes), the first
// kernel's blocks b * kCompactTiles on.
__global__ void __launch_bounds__(kThreads) compact_kernel(
    int n, int cap, const bool* __restrict__ gate, const int* __restrict__ gated,
    const float* __restrict__ org, const float* __restrict__ dir, long long* __restrict__ idx,
    float* __restrict__ org_c, float* __restrict__ dir_c, int* __restrict__ total) {
  __shared__ int s_part[2][kWarps];
  __shared__ int s_off[kCompactTiles * kWarps];
  __shared__ int s_before, s_all;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blocks = (n + kThreads - 1) / kThreads;
  const int first = blockIdx.x * kCompactTiles;
  // Gated lanes before this block's, and in all: the first kernel's counts.
  int before = 0, all = 0;
  for (int b = tid; b < blocks; b += kThreads) {
    const int c = gated[b];
    all += c;
    if (b < first) before += c;
  }
  before = warp_sum(before);
  all = warp_sum(all);
  if (lane == 0) {
    s_part[0][warp] = before;
    s_part[1][warp] = all;
  }
  // Each tile of kThreads lanes: a ballot a warp, its count in s_off, in
  // lane order (tile, then warp).
  const long long base = (long long)blockIdx.x * kCompactLanes;
  unsigned vote[kCompactTiles];
#pragma unroll
  for (int s = 0; s < kCompactTiles; ++s) {
    const long long i = base + s * kThreads + tid;
    vote[s] = __ballot_sync(0xffffffffu, i < n && gate[i]);
    if (lane == 0) s_off[s * kWarps + warp] = __popc(vote[s]);
  }
  __syncthreads();
  if (warp == 0) {
    // The exclusive scan of the 64 warp counts, two a lane.
    const int a = s_off[2 * lane], b = s_off[2 * lane + 1];
    int incl = a + b;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    s_off[2 * lane] = incl - a - b;
    s_off[2 * lane + 1] = incl - b;
    if (lane == 0) {
      int sb = 0, sa = 0;
      for (int k = 0; k < kWarps; ++k) {
        sb += s_part[0][k];
        sa += s_part[1][k];
      }
      s_before = sb;
      s_all = sa;
    }
  }
  __syncthreads();
  before = s_before;
  all = s_all;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kCompactTiles; ++s) {
    if (!((vote[s] >> lane) & 1u)) continue;
    const int r = before + s_off[s * kWarps + warp] + __popc(vote[s] & below);
    if (r >= cap) continue;
    const long long i = base + s * kThreads + tid;
    idx[r] = i;
    copy3(org, i, org_c, r);
    copy3(dir, i, dir_c, r);
  }
  // Fill slots [all, cap), spread over the grid, carry lane n - 1's ray.
  for (long long j = (long long)all + (long long)blockIdx.x * kThreads + tid; j < cap;
       j += (long long)gridDim.x * kThreads) {
    idx[j] = n;
    copy3(org, n - 1, org_c, j);
    copy3(dir, n - 1, dir_c, j);
  }
  if (blockIdx.x == 0 && tid == 0) *total = all;
}

// geometry/bezier.intersect_bezier's winner normal (patch_tangents, the
// cross product flipped toward the viewer, normalised) and row.
__global__ void __launch_bounds__(kThreads) bezier_kernel(
    int cap, int n_lanes, const long long* __restrict__ idx, const float* __restrict__ dir,
    const float* __restrict__ t, const float* __restrict__ u, const float* __restrict__ v,
    const int* __restrict__ pid, const bool* __restrict__ hit,
    const float* __restrict__ ctrl, float* __restrict__ rows) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= cap) return;
  const long long lane = idx ? idx[j] : j;
  if (lane < 0 || lane >= n_lanes) return;      // a fill slot
  const float uu = u[j], vv = v[j];
  float bu[4], bv[4], dbu[4], dbv[4];
  bern(uu, bu);
  bern(vv, bv);
  dbern(uu, dbu);
  dbern(vv, dbv);
  const float* g = ctrl + 48LL * pid[j];
  float su[3], sv[3];
  for (int c = 0; c < 3; ++c) {
    // (b[i] ctrl[i, k, c]) summed over i, then (b[k] row[k, c]) over k.
    float gv[4], hv[4];
    for (int k = 0; k < 4; ++k) {
      float a = bv[0] * g[k * 3 + c], h = dbv[0] * g[k * 3 + c];
      for (int r = 1; r < 4; ++r) {
        a = a + bv[r] * g[(r * 4 + k) * 3 + c];
        h = h + dbv[r] * g[(r * 4 + k) * 3 + c];
      }
      gv[k] = a;
      hv[k] = h;
    }
    float a = dbu[0] * gv[0], h = bu[0] * hv[0];
    for (int k = 1; k < 4; ++k) {
      a = a + dbu[k] * gv[k];
      h = h + bu[k] * hv[k];
    }
    su[c] = a;
    sv[c] = h;
  }
  V3 n = cross({su[0], su[1], su[2]}, {sv[0], sv[1], sv[2]});
  if (dot(n, ld3(dir, j)) > 0.0f) n = neg(n);
  n = normalize(n);
  float* row = rows + 7 * lane;
  row[0] = t[j];
  row[1] = uu;
  row[2] = vv;
  row[3] = hit[j] ? 1.0f : 0.0f;
  row[4] = n.x;
  row[5] = n.y;
  row[6] = n.z;
}

__global__ void __launch_bounds__(kThreads) shade_kernel(const WalkScene sc, const WalkLanes w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x == 0) {
    // Refills this segment: the sum of the refill kernel's block counts.
    __shared__ int s_need;
    if (threadIdx.x == 0) s_need = 0;
    __syncthreads();
    int part = 0;
    for (int b = threadIdx.x; b < w.blocks; b += kThreads) part += w.partial[b];
    atomicAdd(&s_need, part);
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n_need = s_need, off = *w.rr_off;
      // Round-robin: refill k (0-based) goes to light (off + k) % L.
      for (int l = 0; l < sc.L; ++l) {
        const int first = ((l - off) % sc.L + sc.L) % sc.L;
        const int cnt = n_need > first ? (n_need - first - 1) / sc.L + 1 : 0;
        w.emitted_out[l] = w.emitted[l] + (float)cnt;
      }
      *w.rr_off_out = (off + n_need) % sc.L;
    }
  }
  if (i >= w.n) return;

  const bool need = !w.alive[i];
  const V3 o = ld3(w.o_r, i), d = ld3(w.d_r, i), f = ld3(w.f_r, i);
  const Surface sf = surface(sc, o, d, w.t_a[i], w.obj_a[i],
                             sc.B > 0 ? w.rows + 7LL * i : nullptr,
                             sc.B > 0 ? w.gate + i : nullptr);
  const bool hit = sf.hit, is_sphere = sf.is_sphere;
  const V3 pos = sf.pos, n = sf.n, color = sf.color;

  // The material of the hit object (object 0 for a miss).
  const float* m = sc.mat + 5LL * clampi(hit ? sf.obj : -1, 0, sc.nobj - 1);
  const float dp = m[0], rp = m[1], rr = m[2], rn = m[4];
  st3(w.pos, i, pos);
  st3(w.nrm, i, n);
  w.valid[i] = hit && m[3] > 0.5f;

  // render/photon._continue: roulette without dividing by the branch
  // probability, unless debiased.
  const float allp = dp + rp + rr;
  const float r = w.ur[i] * allp;
  const int branch = dp > r ? 0 : (dp + rp > r ? 1 : 2);
  V3 nd;
  if (branch == 0) {
    nd = cosine_dir(w.u1[i], w.u2[i], n);
  } else if (branch == 1) {
    nd = normalize(reflect(d, n));
  } else {
    const bool ins = is_sphere && w.ins_a[i];
    const float safe = fabsf(rn) < 1e-6f ? 1.0f : rn;
    const float eta = ins ? safe : 1.0f / safe;
    nd = normalize(refract(d, ins ? neg(n) : n, eta));
  }
  V3 nf = {color.x * f.x, color.y * f.y, color.z * f.z};
  if (w.debias) {
    const float sel = branch == 0 ? dp : (branch == 1 ? rp : rr);
    const float bp = sel / (allp > 0.0f ? allp : 1.0f);
    const float q = bp > 1e-8f ? bp : 1.0f;
    nf = {nf.x / q, nf.y / q, nf.z / q};
  }
  st3(w.nd, i, nd);
  st3(w.nf, i, nf);
  const int depth = (need ? 0 : w.depth[i]) + 1;
  w.depth_out[i] = depth;
  w.alive_out[i] = hit && depth < w.segs;
}

}  // namespace

// Each returns cudaErrorInvalidValue, launching nothing, for a shape the
// kernels cannot take (no lane, no plane or sphere, a light count below 1,
// more than 2^31 / 7 lanes).
extern "C" int rt3_walk_refill(const WalkScene* sc, const WalkLanes* w, void* stream) {
  if (w->n < 1 || w->n > (1 << 28) || sc->P < 1 || sc->S < 1 || sc->L < 1 || sc->nobj < 1 ||
      w->blocks != (w->n + kThreads - 1) / kThreads)
    return (int)cudaErrorInvalidValue;
  refill_kernel<<<w->blocks, kThreads, 0, (cudaStream_t)stream>>>(*sc, *w);
  return (int)cudaGetLastError();
}

// `gated`: the first kernel's gated lanes a block of kThreads lanes (refill's
// or eye.cu's hit's); `total` takes the whole gated count.
extern "C" int rt3_walk_compact(int n, int cap, const bool* gate, const int* gated,
                                const float* org, const float* dir, long long* idx, float* org_c,
                                float* dir_c, int* total, void* stream) {
  if (n < 1 || n > (1 << 28) || cap < 1 || cap > n) return (int)cudaErrorInvalidValue;
  compact_kernel<<<(n + kCompactLanes - 1) / kCompactLanes, kThreads, 0, (cudaStream_t)stream>>>(
      n, cap, gate, gated, org, dir, idx, org_c, dir_c, total);
  return (int)cudaGetLastError();
}

extern "C" int rt3_walk_bezier(int cap, int n_lanes, const long long* idx, const float* dir,
                               const float* t, const float* u, const float* v, const int* pid,
                               const bool* hit, const float* ctrl, float* rows, void* stream) {
  if (cap < 0 || n_lanes < 1 || n_lanes > (1 << 28)) return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaSuccess;
  bezier_kernel<<<(cap + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      cap, n_lanes, idx, dir, t, u, v, pid, hit, ctrl, rows);
  return (int)cudaGetLastError();
}

extern "C" int rt3_walk_shade(const WalkScene* sc, const WalkLanes* w, void* stream) {
  if (w->n < 1 || w->n > (1 << 28) || sc->P < 1 || sc->S < 1 || sc->L < 1 || sc->nobj < 1 ||
      sc->T < 1 || w->blocks != (w->n + kThreads - 1) / kThreads)
    return (int)cudaErrorInvalidValue;
  shade_kernel<<<w->blocks, kThreads, 0, (cudaStream_t)stream>>>(*sc, *w);
  return (int)cudaGetLastError();
}
