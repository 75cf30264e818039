// The photon-deposit pair test, shared by the deposit kernels.
//
// A hit slot (packed row: pos xyz, n xyz, r2, pad) takes a deposit lane
// (rows 0-8 of a (16, Dp) array: pos xyz, n xyz, flux rgb) when
// |h - d|^2 <= r2 and n_h . n_d > 1e-3 (raytrace3_tpu/render/deposit.py,
// reference Raytracer.h:144-159).  The sums are formed in the plain PyTorch
// versions' order, (dx*dx + dy*dy) + dz*dz and (nx*dnx + ny*dny) + nz*dnz,
// and the sources build with -fmad=false, so every kernel takes exactly the
// pairs its plain version takes.

#pragma once

namespace rt3 {

constexpr float kNormalDotMin = 1e-3f;

struct HitSlot {
  float x, y, z, nx, ny, nz, r2;
};

__device__ __forceinline__ HitSlot load_slot(const float* h) {
  return HitSlot{h[0], h[1], h[2], h[3], h[4], h[5], h[6]};
}

__device__ __forceinline__ bool pair_passes(const HitSlot& h, float dx_, float dy_,
                                            float dz_, float dnx, float dny,
                                            float dnz) {
  const float dx = h.x - dx_;
  const float dy = h.y - dy_;
  const float dz = h.z - dz_;
  const float d2 = (dx * dx + dy * dy) + dz * dz;
  const float ndot = (h.nx * dnx + h.ny * dny) + h.nz * dnz;
  return d2 <= h.r2 && ndot > kNormalDotMin;
}

__device__ __forceinline__ void store_row(float* o, float cnt, float f0, float f1,
                                          float f2) {
  o[0] = cnt;
  o[1] = f0;
  o[2] = f1;
  o[3] = f2;
  o[4] = 0.0f;
  o[5] = 0.0f;
  o[6] = 0.0f;
  o[7] = 0.0f;
}

}  // namespace rt3
