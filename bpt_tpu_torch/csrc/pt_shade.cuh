// One PT bounce for one lane, shared by the fused PT megakernel
// (pt_megakernel.cu) and the per-bounce wave kernel (pt_wave.cu): the
// estimator of make_bounce (bpt_tpu/ops/pallas/pt_kernel.py:177-675) with
// real branches for its masks.  The closest hit comes from a provider the
// caller passes in (bvh_walk.cuh): the megakernel's brute-force sweep over
// shared memory, the BVH walk, or a hit computed by an earlier launch.  On
// a scene with volumes (VOLS) the free-flight override of volume.cuh
// follows the closest hit.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "volume.cuh"

namespace bpt {

constexpr int MAX_MATS = 16;
constexpr int MAX_LIGHTS = 16;
constexpr int MAT_STRIDE = 6;   // mtype, albedo(3), fuzz, ior
constexpr int LGT_STRIDE = 13;  // v0(3) e1(3) e2(3) n(3) area(1)
constexpr int LGT_TAB = MAX_LIGHTS * LGT_STRIDE + 3;  // background at the tail
constexpr int NU = 9;           // uniform slots per bounce (models.pt)

enum { M_LAM = 0, M_METAL = 1, M_DIEL = 2, M_LIGHT = 3, M_ISO = 4 };
enum { U_MIX = 0, U_LPICK = 1, U_LU = 2, U_LV = 3, U_B1 = 4, U_B2 = 5,
       U_DIEL = 6, U_FZ1 = 7, U_FZ2 = 8 };

// A lane's draws: the injected buffer when given, else threefry keyed by
// slot with (sample id, bounce) as the counter.  A bounce has nu = NU + V
// slots, the V volume free-flight slots (single draws) last.
struct Draws {
  const float* ubuf;  // [depth*nu, B] or null
  int B;
  const uint32_t* keys;  // [2*nu] slot keys
  uint32_t ridu;
  int lane;
  int nu;

  // two uniforms (slot, slot+1) from one threefry call (both words)
  __device__ __forceinline__ void two(int b, int slot, float& a, float& c) const {
    if (ubuf) {
      a = ubuf[(size_t)(b * nu + slot) * B + lane];
      c = ubuf[(size_t)(b * nu + slot + 1) * B + lane];
      return;
    }
    uint32_t x0 = ridu, x1 = (uint32_t)b;
    threefry2x32(keys[2 * slot], keys[2 * slot + 1], x0, x1);
    a = bits_to_unit(x0);
    c = bits_to_unit(x1);
  }

  __device__ __forceinline__ float one(int b, int slot) const {
    if (ubuf) return ubuf[(size_t)(b * nu + slot) * B + lane];
    uint32_t x0 = ridu, x1 = (uint32_t)b;
    threefry2x32(keys[2 * slot], keys[2 * slot + 1], x0, x1);
    return bits_to_unit(x0);
  }
};

// A lane's path: the ray, its throughput and the radiance gathered so far.
struct PathState {
  float ox, oy, oz, dx, dy, dz;
  float tr, tg, tb;
  float ar, ag, ab;
};

// One bounce b of the path in `s`.  `closest(ox, oy, oz, dx, dy, dz)`
// returns the ray's Hit.  Adds the bounce's radiance to s.a*; returns true
// and moves the ray on if the path continues, false if it ends here (miss,
// emitter, or a mixture pdf of 0).  `mat` [MAX_MATS*6] and `lgt` [LGT_TAB]
// are the packed tables of ops/kernels/pt_kernel.py::_pack_tables.  VOLS:
// the free-flight override over `vol` (volume.cuh) runs before the miss
// test, a miss being a surface t of inf, so a ray that leaves the scene
// can still scatter in a volume; a volume hit writes its phase material
// to *vmat_out when given, and -1 marks a surface hit or a miss there.
template <bool VOLS, class Closest>
__device__ __forceinline__ bool pt_bounce(const float* mat, const float* lgt,
                                          int L, const Draws& dr, int b,
                                          Closest& closest, PathState& s,
                                          const VolTables* vol = nullptr,
                                          int* vmat_out = nullptr) {
  const float cox = s.ox, coy = s.oy, coz = s.oz;
  const float cdx = s.dx, cdy = s.dy, cdz = s.dz;
  const Hit h = closest(cox, coy, coz, cdx, cdy, cdz);
  float t_hit = h.t;
  float gnx, gny, gnz;
  int mid;
  bool in_vol = false;
  if constexpr (VOLS) {
    in_vol = free_flight(*vol, cox, coy, coz, cdx, cdy, cdz, t_hit, mid,
                         [&](int v) { return dr.one(b, NU + v); });
    if (vmat_out) *vmat_out = in_vol ? mid : -1;
  }
  if (in_vol) {
    // the reference's arbitrary normal (1, 0, 0), front face true
    // (constant_medium.h:48-49): set against the ray, the flip below
    // yields front
    gnx = cdx < 0.0f ? 1.0f : -1.0f;
    gny = 0.0f;
    gnz = 0.0f;
  } else if (h.tri < 0) {  // miss -> background (light-table tail)
    const float* bg = &lgt[MAX_LIGHTS * LGT_STRIDE];
    s.ar = s.ar + s.tr * bg[0];
    s.ag = s.ag + s.tg * bg[1];
    s.ab = s.ab + s.tb * bg[2];
    return false;
  } else {
    closest.surface(h.tri, gnx, gny, gnz, mid);
  }
  const bool front = (cdx * gnx + cdy * gny + cdz * gnz) < 0.0f;
  const float fsign = front ? 1.0f : -1.0f;
  const float nx = gnx * fsign, ny = gny * fsign, nz = gnz * fsign;
  const float px = cox + t_hit * cdx;
  const float py = coy + t_hit * cdy;
  const float pz = coz + t_hit * cdz;

  const float* m = &mat[mid * MAT_STRIDE];
  const int mtype = (int)m[0];
  const float alb_r = m[1], alb_g = m[2], alb_b = m[3];

  if (mtype == M_LIGHT) {  // one-sided emitter; lights do not scatter
    if (front) {
      s.ar = s.ar + s.tr * alb_r;
      s.ag = s.ag + s.tg * alb_g;
      s.ab = s.ab + s.tb * alb_b;
    }
    return false;
  }

  float ndx, ndy, ndz;  // next direction
  if (mtype == M_METAL || mtype == M_DIEL) {
    // ---- delta continuation (pt_kernel.py:491-535)
    float u_dl, u_f1;
    dr.two(b, U_DIEL, u_dl, u_f1);
    const float u_f2 = dr.one(b, U_FZ2);  // odd tail slot: single draw
    if (mtype == M_METAL) {
      const float dn = cdx * nx + cdy * ny + cdz * nz;
      float rfx = cdx - 2.0f * dn * nx;
      float rfy = cdy - 2.0f * dn * ny;
      float rfz = cdz - 2.0f * dn * nz;
      normalize_safe(rfx, rfy, rfz);
      const float sz = 1.0f - 2.0f * u_f1;
      const float sr = sqrtf(fmaxf(0.0f, 1.0f - sz * sz));
      const float sphi = TWO_PI_F * u_f2;
      const float fuzz = m[4];
      ndx = rfx + fuzz * (sr * cosf(sphi));
      ndy = rfy + fuzz * (sr * sinf(sphi));
      ndz = rfz + fuzz * sz;
      s.tr = s.tr * alb_r;
      s.tg = s.tg * alb_g;
      s.tb = s.tb * alb_b;
    } else {
      const float ior = m[5];
      const float ri = front ? 1.0f / ior : ior;
      float udx = cdx, udy = cdy, udz = cdz;
      normalize_safe(udx, udy, udz);
      const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
      const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
      float r0 = (1.0f - ri) / (1.0f + ri);
      r0 = r0 * r0;
      const float omc = 1.0f - cos_t;
      const float schlick = r0 + (1.0f - r0) * omc * omc * omc * omc * omc;
      if (ri * sin_t > 1.0f || schlick > u_dl) {
        const float udn = udx * nx + udy * ny + udz * nz;
        ndx = udx - 2.0f * udn * nx;
        ndy = udy - 2.0f * udn * ny;
        ndz = udz - 2.0f * udn * nz;
      } else {
        const float perp_x = ri * (udx + cos_t * nx);
        const float perp_y = ri * (udy + cos_t * ny);
        const float perp_z = ri * (udz + cos_t * nz);
        const float par = -sqrtf(fabsf(
            1.0f - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z)));
        ndx = perp_x + par * nx;
        ndy = perp_y + par * ny;
        ndz = perp_z + par * nz;
      }
      // attenuation 1: tr * 1.0 is tr
    }
  } else {
    // ---- diffuse: 50/50 mixture of light dir and bsdf dir
    float u_mix, u_lp, u_lu, u_lv, u_b1, u_b2;
    dr.two(b, U_MIX, u_mix, u_lp);
    dr.two(b, U_LU, u_lu, u_lv);
    dr.two(b, U_B1, u_b1, u_b2);
    const bool is_iso = mtype == M_ISO;

    float sdx, sdy, sdz;
    if (u_mix < 0.5f) {
      // light dir: uniform light pick + uniform point (p - x, unnormalized)
      int lidx = (int)(u_lp * (float)L);
      lidx = min(max(lidx, 0), L - 1);
      const float* lt = &lgt[lidx * LGT_STRIDE];
      const bool flip = (u_lu + u_lv) > 1.0f;
      const float bu = flip ? 1.0f - u_lu : u_lu;
      const float bv = flip ? 1.0f - u_lv : u_lv;
      sdx = lt[0] + bu * lt[3] + bv * lt[6] - px;
      sdy = lt[1] + bu * lt[4] + bv * lt[7] - py;
      sdz = lt[2] + bu * lt[5] + bv * lt[8] - pz;
    } else if (is_iso) {
      const float isz = 1.0f - 2.0f * u_b1;
      const float isr = sqrtf(fmaxf(0.0f, 1.0f - isz * isz));
      const float isphi = TWO_PI_F * u_b2;
      sdx = isr * cosf(isphi);
      sdy = isr * sinf(isphi);
      sdz = isz;
    } else {
      // cosine about n through the reference ONB (onb.h:4-14)
      float wx = nx, wy = ny, wz = nz;
      normalize_safe(wx, wy, wz);
      const bool pick_axis = fabsf(wx) > 0.9f;
      const float axx = pick_axis ? 0.0f : 1.0f;
      const float axy = pick_axis ? 1.0f : 0.0f;
      float vx = wy * 0.0f - wz * axy;
      float vy = wz * axx - wx * 0.0f;
      float vz = wx * axy - wy * axx;
      normalize_safe(vx, vy, vz);
      const float ux = wy * vz - wz * vy;
      const float uy = wz * vx - wx * vz;
      const float uz = wx * vy - wy * vx;
      const float cphi = TWO_PI_F * u_b1;
      const float csq = sqrtf(u_b2);
      const float clx = cosf(cphi) * csq;
      const float cly = sinf(cphi) * csq;
      const float clz = sqrtf(1.0f - u_b2);
      sdx = clx * ux + cly * vx + clz * wx;
      sdy = clx * uy + cly * vy + clz * wy;
      sdz = clx * uz + cly * vz + clz * wz;
    }

    // mixture pdf: 0.5 * light_pdf + 0.5 * bsdf_pdf
    const float d_len2 = sdx * sdx + sdy * sdy + sdz * sdz;
    const float d_len = sqrtf(d_len2);
    float lacc = 0.0f;
    for (int li = 0; li < L; ++li) {
      const float* lt = &lgt[li * LGT_STRIDE];
      bool valid;
      const float t = moller_trumbore(px, py, pz, sdx, sdy, sdz, lt, valid);
      if (valid && t >= T_MIN) {
        const float dist2 = t * t * d_len2;
        const float cosine =
            fabsf(sdx * lt[9] + sdy * lt[10] + sdz * lt[11]) / d_len;
        const float area = lt[12];
        if (area > 0.0f && cosine > 0.0f) {
          lacc = lacc + dist2 / (cosine * area);
        }
      }
    }
    const float lpdf = lacc / (float)L;

    float nnx = sdx, nny = sdy, nnz = sdz;
    normalize_safe(nnx, nny, nnz);
    const float cos_nd = nnx * nx + nny * ny + nnz * nz;
    const float bpdf = is_iso ? INV_4PI_F : fmaxf(0.0f, cos_nd / PI_F);
    const float pdf_val = 0.5f * lpdf + 0.5f * bpdf;
    float scat_pdf = 0.0f;
    if (is_iso) {
      scat_pdf = INV_4PI_F;
    } else if (mtype == M_LAM) {
      scat_pdf = cos_nd < 0.0f ? 0.0f : cos_nd / PI_F;
    }
    if (!(pdf_val > 0.0f)) return false;
    const float w = scat_pdf / pdf_val;
    s.tr = s.tr * alb_r * w;
    s.tg = s.tg * alb_g * w;
    s.tb = s.tb * alb_b * w;
    ndx = sdx;
    ndy = sdy;
    ndz = sdz;
  }
  s.ox = px;
  s.oy = py;
  s.oz = pz;
  s.dx = ndx;
  s.dy = ndy;
  s.dz = ndz;
  return true;
}

}  // namespace bpt
