// The nearest surface of a ray, shared by the photon walk's kernels
// (walk.cu) and the eye's (eye.cu): the scene's tables, the vector maths,
// the NaN-propagating min, max and clamps, the analytic plane and sphere
// hits, the Bezier object's box gate, and the hit's position, normal, u/v
// and atlas colour once the Bezier winner is merged in.
//
// Numerics as walk.cu states them: built with -fmad=false and without fast
// math, in the op path's operation order (geometry/*.py, core/vecmath.py,
// textures/texture.py), so each product and sum rounds as the PyTorch
// operators round it on the card.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-4f;                          // M_EPS as float32
constexpr float kEps2 = (float)(1e-4 * 1e-4);          // M_EPS * M_EPS
constexpr float kMaxDist = 1e9f;
constexpr float kFourPi = (float)(4.0 * 3.14159265358979323846);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kLim = (float)(1.0 - 1e-6);            // sphere_uv's clamp
constexpr float kInvPi = 1.0f / (float)3.14159265358979323846;
constexpr float kInvTwoPi = 1.0f / kTwoPi;

}  // namespace

// The scene's tables (layouts of ops/walk_kernel.py).  `mat` is the
// material table of the kernels' caller: render/photon.py's five columns in
// the walk, render/eye.py's thirteen in the eye.
struct WalkScene {
  const float* plane_p0;     // (P, 3)
  const float* plane_n;      // (P, 3)
  const float* plane_umod;   // (P,) |texU|
  const float* plane_vmod;   // (P,) |texV|
  const float* sph_c;        // (S, 3)
  const float* sph_r;        // (S,)
  const float* sph_tu;       // (3,)
  const float* sph_tv;       // (3,)
  const float* mat;          // walk (nobj, 5): diff_p, refl_p, refr_p, is_diff, refrn;
                             // eye (nobj, 13): is_diff, is_refl, is_refr, diff, refl, refr, refrn
  const float* obj_color;    // (nobj, 3)
  const int* obj_tex;        // (nobj,) atlas id, -1 = flat colour
  const float* atlas;        // (T, H, W, 3)
  const float* light_pos;    // (L, 3)
  const float* light_color;  // (L, 3)
  const float* ctrl;         // (B, 4, 4, 3), null without a Bezier object
  int P, S, L, nobj, T, H, W, B, uv_quirk;
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

// The Bezier object's box into lohi[6] (min xyz, max xyz) for the block: min
// and max over every control point (exact in any order; the points hold no
// NaN).  `box` holds 6 x (warps a block) floats of shared memory; every
// thread of the block calls this.
__device__ __forceinline__ void bezier_box(const WalkScene& sc, float* box, float* lohi) {
  const int warps = blockDim.x >> 5;
  float m[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int p = threadIdx.x; p < sc.B * 16; p += blockDim.x) {
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
    for (int c = 0; c < 6; ++c) box[c * warps + (threadIdx.x >> 5)] = m[c];
  __syncthreads();
  if (threadIdx.x < 6) {
    float r = box[threadIdx.x * warps];
    for (int k = 1; k < warps; ++k)
      r = threadIdx.x < 3 ? fminf(r, box[threadIdx.x * warps + k])
                          : fmaxf(r, box[threadIdx.x * warps + k]);
    lohi[threadIdx.x] = r;
  }
  __syncthreads();
}

// geometry/plane.intersect_planes, then geometry/sphere.intersect_spheres;
// the first minimum over planes then spheres: its t, object and inside flag.
__device__ __forceinline__ void analytic_hit(const WalkScene& sc, V3 o, V3 d, float& best,
                                             int& obj, bool& inside) {
  best = 0.0f;
  obj = -1;
  inside = false;
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
}

// geometry/aabb.slab_test against the object's box lohi, t_eps = 0.
__device__ __forceinline__ bool box_gate(const float* lohi, V3 o, V3 d) {
  float tnear = 0.0f, tfar = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float inv = 1.0f / comp(d, c);
    const float t0 = (lohi[c] - comp(o, c)) * inv;
    const float t1 = (lohi[3 + c] - comp(o, c)) * inv;
    const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
    tnear = c == 0 ? lo : nan_max(tnear, lo);
    tfar = c == 0 ? hi : nan_min(tfar, hi);
  }
  if (tnear != tnear) tnear = -INFINITY;
  if (tfar != tfar) tfar = INFINITY;
  return tfar >= (tnear < 0.0f ? 0.0f : tnear);
}

// A lane's Bezier row (t, u, v, hit, n) before the compacted solve: no root
// (bezier.py's fill).
__device__ __forceinline__ void no_root(float* row) {
  row[0] = kMaxDist;
  row[1] = row[2] = row[3] = row[4] = row[5] = 0.0f;
  row[6] = 1.0f;
}

// The nearest hit as geometry/scene.intersect_scene resolves it.
struct Surface {
  int obj;                   // the first minimum's object (a plane on a miss)
  bool hit, is_sphere;
  V3 pos, n, color;
};

// The Bezier winner (row: t, u, v, hit, n; gate: its box gate, both read
// only with a Bezier object) merged into the nearest analytic hit (t, obj)
// as torch.argmin's first minimum; then position, normal, u/v (with the
// teapot's u/t quirk) and colour (atlas or flat).
__device__ __forceinline__ Surface surface(const WalkScene& sc, V3 o, V3 d, float t, int obj,
                                           const float* row, const bool* gate) {
  const int bez = sc.P + sc.S;
  if (sc.B > 0) {
    const bool hb = row[3] > 0.5f && *gate;
    const float tb = hb ? row[0] : kMaxDist;
    if (less_nan(tb, t)) {
      t = tb;
      obj = bez;
    }
  }
  Surface s;
  s.obj = obj;
  s.hit = t < kMaxDist;
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
  s.color = tex >= 0 ? sample_atlas(sc, tex, u, v) : ld3(sc.obj_color, oc);
  s.pos = pos;
  s.n = n;
  s.is_sphere = is_sphere;
  return s;
}

}  // namespace
