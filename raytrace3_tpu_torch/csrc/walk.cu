// One segment of the persistent-lane photon walk (render/photon.py,
// regen_segment) as three kernels around the Bezier compaction and the
// Newton kernel (csrc/newton.cu), which run between them unchanged:
//
//   rt3_walk_refill  one thread a lane: refill a dead lane from its light
//                    (the drawn z and phi), the nearest plane and sphere hit
//                    (t, object, inside), the Bezier object's box gate that
//                    feeds the compaction, the lane's Bezier row set to "no
//                    root", and each block's count of refilled lanes;
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
// issue the segment in 3 launches beside the draws, the compaction and
// Newton.
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
// Numerics: built with -fmad=false and without fast math, and written in
// the op path's operation order (render/photon.py, geometry/*.py,
// core/vecmath.py, textures/texture.py), so each product and sum rounds as
// the PyTorch operators round it on the card: dot products from the left,
// a division by a Python scalar as PyTorch's CUDA kernel does it (times the
// float reciprocal), comparisons with float32 constants, NaN-propagating
// min/max and clamps, argmin's first minimum with NaN as the least.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-4f;                          // M_EPS as float32
constexpr float kEps2 = (float)(1e-4 * 1e-4);          // M_EPS * M_EPS
constexpr float kMaxDist = 1e9f;
constexpr float kFourPi = (float)(4.0 * 3.14159265358979323846);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kLim = (float)(1.0 - 1e-6);            // sphere_uv's clamp
constexpr float kInvPi = 1.0f / (float)3.14159265358979323846;
constexpr float kInvTwoPi = 1.0f / kTwoPi;

}  // namespace

// The scene's tables, as render/photon.py reads them (layouts of
// ops/walk_kernel.py).
struct WalkScene {
  const float* plane_p0;     // (P, 3)
  const float* plane_n;      // (P, 3)
  const float* plane_umod;   // (P,) |texU|
  const float* plane_vmod;   // (P,) |texV|
  const float* sph_c;        // (S, 3)
  const float* sph_r;        // (S,)
  const float* sph_tu;       // (3,)
  const float* sph_tv;       // (3,)
  const float* mat;          // (nobj, 5): diff_p, refl_p, refr_p, is_diff, refrn
  const float* obj_color;    // (nobj, 3)
  const int* obj_tex;        // (nobj,) atlas id, -1 = flat colour
  const float* atlas;        // (T, H, W, 3)
  const float* light_pos;    // (L, 3)
  const float* light_color;  // (L, 3)
  const float* ctrl;         // (B, 4, 4, 3), null without a Bezier object
  int P, S, L, nobj, T, H, W, B, uv_quirk;
};

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

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void st3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float comp(V3 a, int c) { return c == 0 ? a.x : (c == 1 ? a.y : a.z); }

// core/vecmath.dot: the products, summed x + y + z from the left.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float x = a.x * b.x, y = a.y * b.y, z = a.z * b.z;
  return x + y + z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 normalize(V3 v) {
  const float n2 = dot(v, v);
  if (n2 < kEps2) return v;
  const float m = sqrtf(n2);
  return {v.x / m, v.y / m, v.z / m};
}

// d - (2 (d . n)) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  const float k = 2.0f * dot(d, n);
  return {d.x - k * n.x, d.y - k * n.y, d.z - k * n.z};
}

__device__ __forceinline__ V3 refract(V3 d, V3 n, float eta) {
  const float ci = -dot(n, d);
  const float cr2 = 1.0f - (1.0f - ci * ci) * eta * eta;
  if (!(cr2 > kEps)) return reflect(d, n);
  const float k = eta * ci - sqrtf(cr2);
  return {d.x * eta + n.x * k, d.y * eta + n.y * k, d.z * eta + n.z * k};
}

__device__ __forceinline__ float clamp_min0(float x) { return x < 0.0f ? 0.0f : x; }

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.minimum / maximum, and amin / amax over a row: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
}

// argmin's order: a NaN is less than any number.
__device__ __forceinline__ bool less_nan(float a, float b) {
  return a < b || (a != a && b == b);
}

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

// textures/texture.sample_atlas at one lane.
__device__ V3 sample_atlas(const WalkScene& sc, int tex, float u, float v) {
  const int tid = clampi(tex, 0, sc.T - 1);
  const float row = (u - floorf(u)) * (float)sc.H;
  const float col = (v - floorf(v)) * (float)sc.W;
  int r1 = (int)floorf(row + 1e-10f);
  int c1 = (int)floorf(col + 1e-10f);
  const float dr = (float)(r1 + 1) - row;
  const float dc = (float)(c1 + 1) - col;
  r1 = r1 >= 0 ? (r1 >= sc.H ? 0 : r1) : sc.H - 1;
  c1 = c1 >= 0 ? (c1 >= sc.W ? 0 : c1) : sc.W - 1;
  const int r2 = (r1 + 1) % sc.H, c2 = (c1 + 1) % sc.W;
  const long long base = (long long)tid * sc.H;
  const V3 q11 = ld3(sc.atlas, (base + r1) * sc.W + c1);
  const V3 q12 = ld3(sc.atlas, (base + r1) * sc.W + c2);
  const V3 q21 = ld3(sc.atlas, (base + r2) * sc.W + c1);
  const V3 q22 = ld3(sc.atlas, (base + r2) * sc.W + c2);
  const float er = 1.0f - dr, ec = 1.0f - dc;
  return {q11.x * dr * dc + q12.x * dr * ec + q21.x * er * dc + q22.x * er * ec,
          q11.y * dr * dc + q12.y * dr * ec + q21.y * er * dc + q22.y * er * ec,
          q11.z * dr * dc + q12.z * dr * ec + q21.z * er * dc + q22.z * er * ec};
}

__global__ void __launch_bounds__(kThreads) refill_kernel(const WalkScene sc, const WalkLanes w) {
  __shared__ float s_box[6][kWarps];
  __shared__ float s_lohi[6];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // The Bezier object's box: min and max over every control point (exact in
  // any order; the points hold no NaN).
  if (sc.B > 0) {
    float m[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int p = threadIdx.x; p < sc.B * 16; p += kThreads) {
      for (int c = 0; c < 3; ++c) {
        const float x = sc.ctrl[3 * p + c];
        m[c] = fminf(m[c], x);
        m[3 + c] = fmaxf(m[3 + c], x);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int c = 0; c < 3; ++c) {
        m[c] = fminf(m[c], __shfl_xor_sync(0xffffffffu, m[c], off));
        m[3 + c] = fmaxf(m[3 + c], __shfl_xor_sync(0xffffffffu, m[3 + c], off));
      }
    }
    if ((threadIdx.x & 31) == 0)
      for (int c = 0; c < 6; ++c) s_box[c][threadIdx.x >> 5] = m[c];
    __syncthreads();
    if (threadIdx.x < 6) {
      float r = s_box[threadIdx.x][0];
      for (int k = 1; k < kWarps; ++k)
        r = threadIdx.x < 3 ? fminf(r, s_box[threadIdx.x][k]) : fmaxf(r, s_box[threadIdx.x][k]);
      s_lohi[threadIdx.x] = r;
    }
    __syncthreads();
  }
  const bool need = i < w.n && !w.alive[i];
  const int refills = __syncthreads_count(need);
  if (threadIdx.x == 0) w.partial[blockIdx.x] = refills;
  if (i >= w.n) return;

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

  // geometry/plane.intersect_planes, then geometry/sphere.intersect_spheres;
  // the first minimum over planes then spheres.
  float best = 0.0f;
  int obj = -1;
  bool inside = false;
  for (int p = 0; p < sc.P; ++p) {
    const V3 n = ld3(sc.plane_n, p);
    const float proj = dot(d, n);
    const float num = dot(sub(ld3(sc.plane_p0, p), o), n);
    const bool par = fabsf(proj) < kEps;
    const float t = num / (par ? 1.0f : proj);
    const float tp = (!par && t > kEps) ? t : kMaxDist;
    if (obj < 0 || less_nan(tp, best)) {
      best = tp;
      obj = p;
    }
  }
  for (int s = 0; s < sc.S; ++s) {
    const V3 L = sub(ld3(sc.sph_c, s), o);
    const float proj = dot(L, d);
    const float r = sc.sph_r[s];
    const float det2 = r * r - (dot(L, L) - proj * proj);
    const bool miss = det2 < kEps;
    const float det = sqrtf(miss ? 1.0f : det2);
    const float d1 = proj - det, d2 = proj + det;
    const bool ins = d1 < kEps;
    const float ts = (!miss && d2 >= kEps) ? (ins ? d2 : d1) : kMaxDist;
    if (obj < 0 || less_nan(ts, best)) {
      best = ts;
      obj = sc.P + s;
      inside = ins;
    }
  }
  w.t_a[i] = best;
  w.obj_a[i] = obj;
  w.ins_a[i] = inside;

  if (sc.B > 0) {
    // geometry/aabb.slab_test against the object's box, t_eps = 0.
    float tnear = 0.0f, tfar = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float inv = 1.0f / comp(d, c);
      const float t0 = (s_lohi[c] - comp(o, c)) * inv;
      const float t1 = (s_lohi[3 + c] - comp(o, c)) * inv;
      const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
      tnear = c == 0 ? lo : nan_max(tnear, lo);
      tfar = c == 0 ? hi : nan_min(tfar, hi);
    }
    if (tnear != tnear) tnear = -INFINITY;
    if (tfar != tfar) tfar = INFINITY;
    w.gate[i] = tfar >= (tnear < 0.0f ? 0.0f : tnear);
    // No root until the compacted solve says otherwise (bezier.py's fill).
    float* row = w.rows + 7LL * i;
    row[0] = kMaxDist;
    row[1] = row[2] = row[3] = row[4] = row[5] = 0.0f;
    row[6] = 1.0f;
  }
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
  const int bez = sc.P + sc.S;
  float t = w.t_a[i];
  int obj = w.obj_a[i];
  const float* row = w.rows + 7LL * i;
  if (sc.B > 0) {
    const bool hb = row[3] > 0.5f && w.gate[i];
    const float tb = hb ? row[0] : kMaxDist;
    if (less_nan(tb, t)) {
      t = tb;
      obj = bez;
    }
  }
  const bool hit = t < kMaxDist;
  const float tc = t > 1e6f ? 1e6f : t;
  const V3 pos = {o.x + tc * d.x, o.y + tc * d.y, o.z + tc * d.z};
  const bool is_plane = obj < sc.P, is_sphere = obj >= sc.P && obj < bez;
  const int pi = clampi(obj, 0, sc.P - 1), si = clampi(obj - sc.P, 0, sc.S - 1);

  V3 n;
  float u, v;
  if (is_sphere) {
    // The outward normal and geometry/sphere.sphere_uv.
    n = normalize(sub(pos, ld3(sc.sph_c, si)));
    const V3 tu = ld3(sc.sph_tu, 0), tv = ld3(sc.sph_tv, 0);
    const float theta = acosf(clip(dot(n, tv), -kLim, kLim));
    const float st = sinf(theta);
    const float tq = dot(n, tu) / (st < 1e-12f ? 1e-12f : st);
    const float ph = acosf(clip(tq, -kLim, kLim));
    u = theta * kInvPi;
    v = ph * kInvTwoPi;
    if (dot(n, cross(tu, tv)) < 0.0f) v = 1.0f - v;
  } else if (is_plane || sc.B == 0) {
    // The stored normal and geometry/plane.plane_uv.
    n = ld3(sc.plane_n, pi);
    const int nd = n.z != 0.0f ? 2 : (n.y != 0.0f ? 1 : 0);
    const V3 dd = sub(pos, ld3(sc.plane_p0, pi));
    v = 0.5f + comp(dd, (nd + 2) % 3) / sc.plane_umod[pi];
    u = 0.5f + comp(dd, (nd + 1) % 3) / sc.plane_vmod[pi];
  } else {
    n = {row[4], row[5], row[6]};
    u = row[1];
    v = sc.uv_quirk ? t : row[2];
  }

  const int oc = clampi(obj, 0, sc.nobj - 1);
  const int tex = sc.obj_tex[oc];
  const V3 color = tex >= 0 ? sample_atlas(sc, tex, u, v) : ld3(sc.obj_color, oc);

  // The material of the hit object (object 0 for a miss).
  const float* m = sc.mat + 5LL * clampi(hit ? obj : -1, 0, sc.nobj - 1);
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
