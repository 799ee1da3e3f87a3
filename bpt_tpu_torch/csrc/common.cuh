// Shared device helpers for the bpt_tpu_torch kernels: the threefry2x32
// block of the kernel RNG stream and the reference's Moller-Trumbore test.
//
// Built with -fmad=false (ops/kernels/build.py): every a*b+c below rounds
// twice, as the plain PyTorch version and the JAX reference do, so branch
// decisions fed by det, u+v <= 1 and t < t_best agree with them.
#pragma once

#include <cstdint>

namespace bpt {

constexpr float MT_EPSILON = 1e-8f;  // triangle.h:43
constexpr float T_MIN = 1e-3f;       // interval(0.001, inf) of scatter rays
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;   // f32(2.0 * PI)
constexpr float INV_4PI_F = 0.0795774715459476679f;   // f32(1 / (4 PI))

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax's threefry2x32 block (jax._src.prng._threefry2x32_lowering); the
// counter (x0, x1) is overwritten with the two output words.
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks2 = k1 ^ k2 ^ 0x1BD11BDAu;
  const int ra[4] = {13, 15, 26, 6};
  const int rb[4] = {17, 29, 16, 24};
  x0 += k1;
  x1 += k2;
#pragma unroll
  for (int i = 0; i < 4; ++i) { x0 += x1; x1 = rotl32(x1, ra[i]) ^ x0; }
  x0 += k2;
  x1 += ks2 + 1u;
#pragma unroll
  for (int i = 0; i < 4; ++i) { x0 += x1; x1 = rotl32(x1, rb[i]) ^ x0; }
  x0 += ks2;
  x1 += k1 + 2u;
#pragma unroll
  for (int i = 0; i < 4; ++i) { x0 += x1; x1 = rotl32(x1, ra[i]) ^ x0; }
  x0 += k1;
  x1 += k2 + 3u;
#pragma unroll
  for (int i = 0; i < 4; ++i) { x0 += x1; x1 = rotl32(x1, rb[i]) ^ x0; }
  x0 += k2;
  x1 += ks2 + 4u;
#pragma unroll
  for (int i = 0; i < 4; ++i) { x0 += x1; x1 = rotl32(x1, ra[i]) ^ x0; }
  x0 += ks2;
  x1 += k1 + 5u;
}

// uint32 -> f32 in [0, 1): jax's mantissa trick.
__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Moller-Trumbore of ray (o, d) against the triangle (v0, e1, e2); the
// operation order of bpt_tpu/ops/pallas/pt_kernel.py:257-270.  Returns t
// and the barycentrics (u, v), with valid = the reference's acceptance
// test minus the t interval.
__device__ __forceinline__ float moller_trumbore_uv(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float* tri, float& u, float& v, bool& valid) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = 1.0f / det;
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  valid = (fabsf(det) >= MT_EPSILON) && (u >= 0.0f) && (u <= 1.0f) &&
          (v >= 0.0f) && (u + v <= 1.0f);
  return t;
}

// The same, when the caller needs only t.
__device__ __forceinline__ float moller_trumbore(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float* tri, bool& valid) {
  float u, v;
  return moller_trumbore_uv(ox, oy, oz, dx, dy, dz, tri, u, v, valid);
}

template <typename F>
__device__ __forceinline__ F inf_of() {
  return F(__int_as_float(0x7f800000));
}

// Moller-Trumbore of ray (o, d) against triangle tv = (v0, e1, e2) in the
// operation order of bpt_tpu/ops/pallas/intersect.py:56-76; valid = the
// reference's acceptance test minus the t interval.  Templated on the
// scalar type: the brute-force hits (intersect.cu) in float32 and float64
// and the float64 BVH walk (wave_walk.cuh) test with it.
template <typename F>
__device__ __forceinline__ F mt_test(const F* tv, F ox, F oy, F oz, F dx, F dy,
                                     F dz, F& u, F& v, bool& valid) {
  const F v0x = tv[0], v0y = tv[1], v0z = tv[2];
  const F e1x = tv[3], e1y = tv[4], e1z = tv[5];
  const F e2x = tv[6], e2y = tv[7], e2z = tv[8];
  const F px = dy * e2z - dz * e2y;
  const F py = dz * e2x - dx * e2z;
  const F pz = dx * e2y - dy * e2x;
  const F det = e1x * px + e1y * py + e1z * pz;
  const F inv = F(1) / det;
  const F tx = ox - v0x;
  const F ty = oy - v0y;
  const F tz = oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  const F qx = ty * e1z - tz * e1y;
  const F qy = tz * e1x - tx * e1z;
  const F qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv;
  const F t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  valid = (fabs(det) >= F(1e-8)) && (u >= F(0)) && (u <= F(1)) && (v >= F(0)) &&
          (u + v <= F(1));
  return t;
}

// What a closest-hit provider reports for one ray: the triangle (-1 on a
// miss) and t.  The provider's surface(tri, ...) gives the triangle's
// geometric normal and material.
struct Hit {
  int tri;
  float t;
};

// normalize with the dead-lane guard of pt_kernel._normalize_safe
__device__ __forceinline__ void normalize_safe(float& x, float& y, float& z) {
  const float n2 = x * x + y * y + z * z;
  const float inv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

}  // namespace bpt
