// One segment of the eye wavefront at one slot a pixel (render/eye.py,
// eye_segment) as two kernels around the Bezier compaction (walk.cu's
// rt3_walk_compact), the Newton kernel (csrc/newton.cu) and the winners'
// rows (walk.cu's rt3_walk_bezier), which run between them unchanged:
//
//   rt3_eye_hit    one thread a lane: the nearest plane and sphere hit (t,
//                  object, inside), the Bezier object's box gate that feeds
//                  the compaction (walk.cu's rt3_walk_compact, which reads
//                  each block's count of gated lanes) and the lane's Bezier
//                  row set to "no root", for every lane, active or not, as
//                  geometry/scene.intersect_scene does; block 0 zeroes the
//                  count of continuations dropped;
//   rt3_eye_shade  one thread a lane: the Bezier winner merged into the
//                  nearest hit, position, normal, u/v and colour
//                  (surface.cuh), the eye's material, the lane's hit-point
//                  row (pos3 | n3 | wgt3 | pixel | valid), the reflected and
//                  refracted continuations, the next lane (the reflection,
//                  else the refraction) and each block's count of second
//                  continuations dropped, added to the count.
//
// Replaces no TPU kernel.  The JAX package's segment
// (raytrace3_tpu/render/eye.py, eye_segment) is a chain of elementwise
// operators that XLA fuses into a few loops; the port ran it as about 480
// PyTorch launches a segment, so the card idled through the eye.  These
// kernels issue the segment in 2 launches beside the compaction, Newton and
// the rows.
//
// What bounds them on an H100: bytes, and at a segment's size the launch.
// A segment's inputs and outputs are 122 bytes a lane (the lanes in, the
// next lanes and the hit-point rows; ops/eye_kernel.eye_segment_bytes)
// against a few hundred float operations, so its least time is those bytes
// over 3.35 TB/s: 9.5 us for the first segment's 262,144 lanes.  As split,
// the kernels move 222 bytes a lane (the analytic hit and the Bezier row
// are written by hit and read by shade; eye_kernel.eye_kernel_bytes).  Design
// as walk.cu's: one thread a lane, lanes in order; the scene's tables stay
// in L1/L2.  The count of dropped continuations is exact: a block count
// (__syncthreads_count) and one integer atomic add a block.
//
// Numerics as walk.cu's (-fmad=false, no fast math, the op path's order of
// operations: render/eye.py, core/types.eta_from_refrn, core/vecmath.py),
// so every lane equals the op path's on the card bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "surface.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMatCols = 13;                           // render/eye._eye_material_lanes

}  // namespace

// One segment's lanes: the lanes in, what the kernels hand each other, and
// the hit-point rows, the next lanes and the count out.
struct EyeLanes {
  const float* o;            // (N, 3) lanes in
  const float* d;
  const float* wgt;
  const int* px;             // (N,)
  const bool* act;           // (N,)
  float* t_a;                // (N,) nearest plane or sphere hit
  int* obj_a;
  bool* ins_a;
  bool* gate;                // (N,) Bezier box gate
  float* rows;               // (N, 7) Bezier winner: t, u, v, hit, n
  int* gated;                // (blocks,) Bezier-gated lanes a block
  float* out;                // (N, 11) hit-point rows
  float* pos;                // (N, 3) next lanes
  float* nd;
  float* nw;
  bool* nv;                  // (N,)
  int* dropped;              // () second continuations dropped
  int n;
};

namespace {

__global__ void __launch_bounds__(kThreads) eye_hit_kernel(const WalkScene sc,
                                                           const EyeLanes w) {
  __shared__ float s_box[6][kWarps];
  __shared__ float s_lohi[6];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (sc.B > 0) bezier_box(sc, &s_box[0][0], s_lohi);
  if (i == 0) *w.dropped = 0;
  bool g = false;
  if (i < w.n) {
    const V3 o = ld3(w.o, i), d = ld3(w.d, i);
    float best;
    int obj;
    bool inside;
    analytic_hit(sc, o, d, best, obj, inside);
    w.t_a[i] = best;
    w.obj_a[i] = obj;
    w.ins_a[i] = inside;

    if (sc.B > 0) {
      g = box_gate(s_lohi, o, d);
      w.gate[i] = g;
      no_root(w.rows + 7LL * i);
    }
  }
  if (sc.B > 0) {
    const int gated = __syncthreads_count(g);
    if (threadIdx.x == 0) w.gated[blockIdx.x] = gated;
  }
}

__global__ void __launch_bounds__(kThreads) eye_shade_kernel(const WalkScene sc,
                                                             const EyeLanes w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool second = false;
  if (i < w.n) {
    const V3 o = ld3(w.o, i), d = ld3(w.d, i), wgt = ld3(w.wgt, i);
    const Surface sf = surface(sc, o, d, w.t_a[i], w.obj_a[i],
                               sc.B > 0 ? w.rows + 7LL * i : nullptr,
                               sc.B > 0 ? w.gate + i : nullptr);
    // The material of the hit object (object 0 for a miss).
    const float* m =
        sc.mat + (long long)kMatCols * clampi(sf.hit ? sf.obj : -1, 0, sc.nobj - 1);
    const bool hit = sf.hit && w.act[i];
    const V3 c = sf.color;
    // colour * weight, then times each lobe's albedo.
    const V3 cw = {c.x * wgt.x, c.y * wgt.y, c.z * wgt.z};

    float* row = w.out + 11LL * i;
    const bool diff = hit && m[0] > 0.5f;
    row[0] = sf.pos.x;
    row[1] = sf.pos.y;
    row[2] = sf.pos.z;
    row[3] = sf.n.x;
    row[4] = sf.n.y;
    row[5] = sf.n.z;
    row[6] = cw.x * m[3];
    row[7] = cw.y * m[4];
    row[8] = cw.z * m[5];
    row[9] = (float)w.px[i];
    row[10] = diff ? 1.0f : 0.0f;

    // The primary continuation: the reflection, else the refraction.
    const bool refl = hit && m[1] > 0.5f, refr = hit && m[2] > 0.5f;
    V3 nd, nw;
    if (refl) {
      nd = normalize(reflect(d, sf.n));
      nw = {cw.x * m[6], cw.y * m[7], cw.z * m[8]};
    } else {
      const bool ins = sf.is_sphere && w.ins_a[i];
      const float rn = m[12];
      const float safe = fabsf(rn) < 1e-6f ? 1.0f : rn;
      const float eta = ins ? safe : 1.0f / safe;
      nd = normalize(refract(d, ins ? neg(sf.n) : sf.n, eta));
      nw = {cw.x * m[9], cw.y * m[10], cw.z * m[11]};
    }
    st3(w.pos, i, sf.pos);
    st3(w.nd, i, nd);
    st3(w.nw, i, nw);
    w.nv[i] = refl || refr;
    second = refl && refr;
  }
  const int drops = __syncthreads_count(second);
  if (threadIdx.x == 0 && drops > 0) atomicAdd(w.dropped, drops);
}

}  // namespace

// Each returns cudaErrorInvalidValue, launching nothing, for a shape the
// kernels cannot take (no lane, no plane or sphere, more than 2^28 lanes).
// The Bezier rows between them are walk.cu's rt3_walk_bezier.
extern "C" int rt3_eye_hit(const WalkScene* sc, const EyeLanes* w, void* stream) {
  if (w->n < 1 || w->n > (1 << 28) || sc->P < 1 || sc->S < 1 || sc->nobj < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (w->n + kThreads - 1) / kThreads;
  eye_hit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*sc, *w);
  return (int)cudaGetLastError();
}

extern "C" int rt3_eye_shade(const WalkScene* sc, const EyeLanes* w, void* stream) {
  if (w->n < 1 || w->n > (1 << 28) || sc->P < 1 || sc->S < 1 || sc->nobj < 1 || sc->T < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (w->n + kThreads - 1) / kThreads;
  eye_shade_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*sc, *w);
  return (int)cudaGetLastError();
}
