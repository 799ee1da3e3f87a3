// Fused PT megakernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of bpt_tpu/ops/pallas/pt_kernel.py
// (_pt_kernel_impl + make_bounce, launched by pt_megakernel and
// pt_megakernel_pixels): raygen, every spp stratum, every bounce,
// brute-force Moller-Trumbore over all triangles, lambertian / metal /
// dielectric / light / isotropic shading, the 50/50 light/BSDF mixture NEE
// and the threefry stream, in one launch.  Untextured, unclustered,
// volume-free scenes with <= 512 triangles, 16 materials and 16 lights.
//
// What bounds it on the H100: FP32 issue and warp divergence, not memory.
// A lane reads its inputs once and writes three floats; per bounce it runs
// ~40 flops for each of the T triangles and each of the L lights, and
// paths end after a data-dependent number of bounces (2.7 on average on
// the cornell box at depth 10), so the lanes of a warp finish at
// different times.
//
// Design: one thread per lane (a ray, or a pixel that walks all its strata
// one after another: the persistent-sample idea of the TPU kernel without
// its lockstep), each path runs to termination with real branches instead
// of masked selects, and the triangle / material / light tables sit in
// shared memory, where every thread of a converged warp reads the same
// word (a broadcast).  Direct mat_tab[mat_id] indexing replaces the TPU
// kernel's masked scans.  Draws are threefry2x32 keyed per slot with the
// bounce in the counter, so a lane's stream does not depend on launch
// shape.  Counters are exact 64-bit integers.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace bpt {

constexpr int MAX_TRIS = 512;
constexpr int MAX_MATS = 16;
constexpr int MAX_LIGHTS = 16;
constexpr int TRI_STRIDE = 13;  // v0(3) e1(3) e2(3) n(3) mat(1)
constexpr int MAT_STRIDE = 6;   // mtype, albedo(3), fuzz, ior
constexpr int LGT_STRIDE = 13;  // v0(3) e1(3) e2(3) n(3) area(1)
constexpr int NU = 9;           // uniform slots per bounce (models.pt)
constexpr int NKEYS = 2 * NU + 4;
constexpr int BLOCK = 128;

enum { M_LAM = 0, M_METAL = 1, M_DIEL = 2, M_LIGHT = 3, M_ISO = 4 };
enum { U_MIX = 0, U_LPICK = 1, U_LU = 2, U_LV = 3, U_B1 = 4, U_B2 = 5,
       U_DIEL = 6, U_FZ1 = 7, U_FZ2 = 8 };

struct Params {
  int pixels;    // 0: rays given (o, d); 1: in-kernel raygen from pixels
  int B, T, L, depth;
  int spp_loop;  // pixels mode: > 1 walks all strata of a pixel
  int sqrt_spp;
  const float* tri;   // [MAX_TRIS * 13]
  const float* mat;   // [MAX_MATS * 6]
  const float* lgt;   // [MAX_LIGHTS * 13 + 3] (background at the tail)
  const uint32_t* keys;  // [2*NU] slot keys (+4 jitter words in pixels mode)
  const float* cam;   // [13] pixel00, du, dv, center, 1/sqrt_spp
  // rays mode: ox, oy, oz, dx, dy, dz; pixels mode: i, j, sx, sy
  const float* in[6];
  const int* rid;     // [B] ray / sample / pixel id; < 0 = inactive lane
  const float* ubuf;  // optional [depth*NU, B] injected uniforms
  float* out_r;
  float* out_g;
  float* out_b;
  unsigned long long* counters;  // [3] rays, tri tests, tri hits
};

struct Tables {
  float tri[MAX_TRIS * TRI_STRIDE];
  float mat[MAX_MATS * MAT_STRIDE];
  float lgt[MAX_LIGHTS * LGT_STRIDE + 3];
  uint32_t keys[NKEYS];
};

// A lane's draws: the injected buffer when given, else threefry keyed by
// slot with (sample id, bounce) as the counter.
struct Draws {
  const float* ubuf;  // [depth*NU, B] or null
  int B;
  const uint32_t* keys;
  uint32_t ridu;
  int lane;

  // two uniforms (slot, slot+1) from one threefry call (both words)
  __device__ __forceinline__ void two(int b, int slot, float& a, float& c) const {
    if (ubuf) {
      a = ubuf[(size_t)(b * NU + slot) * B + lane];
      c = ubuf[(size_t)(b * NU + slot + 1) * B + lane];
      return;
    }
    uint32_t x0 = ridu, x1 = (uint32_t)b;
    threefry2x32(keys[2 * slot], keys[2 * slot + 1], x0, x1);
    a = bits_to_unit(x0);
    c = bits_to_unit(x1);
  }

  __device__ __forceinline__ float one(int b, int slot) const {
    if (ubuf) return ubuf[(size_t)(b * NU + slot) * B + lane];
    uint32_t x0 = ridu, x1 = (uint32_t)b;
    threefry2x32(keys[2 * slot], keys[2 * slot + 1], x0, x1);
    return bits_to_unit(x0);
  }
};

struct Counts {
  unsigned long long rays = 0, tests = 0, hits = 0;
};

// One path from (o, d) to termination: make_bounce's estimator
// (pt_kernel.py:230-675) for one lane, with branches for its masks.
__device__ void trace_path(const Tables& s, int T, int L, int depth,
                           const Draws dr, float cox, float coy, float coz,
                           float cdx, float cdy, float cdz,
                           float& ar, float& ag, float& ab, Counts& cnt) {
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  ar = 0.0f;
  ag = 0.0f;
  ab = 0.0f;
  bool alive = true;
  for (int b = 0; b < depth; ++b) {
    cnt.rays += 1;
    cnt.tests += (unsigned long long)T;

    // ---- closest hit: strict t < t_best keeps the first of equal hits
    float t_hit = __int_as_float(0x7f800000);  // +inf
    int best = -1;
    for (int ti = 0; ti < T; ++ti) {
      bool valid;
      const float t = moller_trumbore(cox, coy, coz, cdx, cdy, cdz,
                                      &s.tri[ti * TRI_STRIDE], valid);
      if (valid && t >= T_MIN && t < t_hit) {
        t_hit = t;
        best = ti;
      }
    }
    if (best < 0) {  // miss -> background (light-table tail)
      const float* bg = &s.lgt[MAX_LIGHTS * LGT_STRIDE];
      ar = ar + tr * bg[0];
      ag = ag + tg * bg[1];
      ab = ab + tb * bg[2];
      alive = false;
      break;
    }
    cnt.hits += 1;

    const float* tri = &s.tri[best * TRI_STRIDE];
    const float gnx = tri[9], gny = tri[10], gnz = tri[11];
    const int mid = (int)tri[12];
    const bool front = (cdx * gnx + cdy * gny + cdz * gnz) < 0.0f;
    const float fsign = front ? 1.0f : -1.0f;
    const float nx = gnx * fsign, ny = gny * fsign, nz = gnz * fsign;
    const float px = cox + t_hit * cdx;
    const float py = coy + t_hit * cdy;
    const float pz = coz + t_hit * cdz;

    const float* m = &s.mat[mid * MAT_STRIDE];
    const int mtype = (int)m[0];
    const float alb_r = m[1], alb_g = m[2], alb_b = m[3];

    if (mtype == M_LIGHT) {  // one-sided emitter; lights do not scatter
      if (front) {
        ar = ar + tr * alb_r;
        ag = ag + tg * alb_g;
        ab = ab + tb * alb_b;
      }
      alive = false;
      break;
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
        tr = tr * alb_r;
        tg = tg * alb_g;
        tb = tb * alb_b;
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
        const float* lt = &s.lgt[lidx * LGT_STRIDE];
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
        const float* lt = &s.lgt[li * LGT_STRIDE];
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
      if (!(pdf_val > 0.0f)) {
        alive = false;
        break;
      }
      const float w = scat_pdf / pdf_val;
      tr = tr * alb_r * w;
      tg = tg * alb_g * w;
      tb = tb * alb_b * w;
      ndx = sdx;
      ndy = sdy;
      ndz = sdz;
    }
    cox = px;
    coy = py;
    coz = pz;
    cdx = ndx;
    cdy = ndy;
    cdz = ndz;
  }
  // depth-exhausted entry still counts (camera.h:256)
  if (alive) cnt.rays += 1;
}

__device__ __forceinline__ void stratum_ray(const float* c, const Tables& s,
                                            uint32_t ridu, float i, float j,
                                            float sx, float sy, float* o,
                                            float* d) {
  // get_ray (camera.h:199-213): stratified jitter from the raygen key
  // (pt_kernel.py:816-833), unnormalized direction
  uint32_t b1 = ridu, b2 = 0u;
  threefry2x32(s.keys[2 * NU], s.keys[2 * NU + 1], b1, b2);
  const float u0 = bits_to_unit(b1);
  const float u1 = bits_to_unit(b2);
  const float recip = c[12];
  const float offx = (sx + u0) * recip - 0.5f;
  const float offy = (sy + u1) * recip - 0.5f;
  const float a = i + offx;
  const float e = j + offy;
  o[0] = c[9];
  o[1] = c[10];
  o[2] = c[11];
  d[0] = c[0] + a * c[3] + e * c[6] - c[9];
  d[1] = c[1] + a * c[4] + e * c[7] - c[10];
  d[2] = c[2] + a * c[5] + e * c[8] - c[11];
}

__global__ void __launch_bounds__(BLOCK) pt_megakernel(const Params p) {
  __shared__ Tables s;
  for (int k = threadIdx.x; k < p.T * TRI_STRIDE; k += blockDim.x) s.tri[k] = p.tri[k];
  for (int k = threadIdx.x; k < MAX_MATS * MAT_STRIDE; k += blockDim.x) s.mat[k] = p.mat[k];
  for (int k = threadIdx.x; k < MAX_LIGHTS * LGT_STRIDE + 3; k += blockDim.x) s.lgt[k] = p.lgt[k];
  const int nkeys = p.pixels ? NKEYS : 2 * NU;
  for (int k = threadIdx.x; k < nkeys; k += blockDim.x) s.keys[k] = p.keys[k];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  Counts cnt;
  if (lane < p.B) {
    const int rid = p.rid[lane];
    float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
    if (rid >= 0) {
      float o[3], d[3], sr, sg, sb;
      if (!p.pixels) {
        const Draws dr{p.ubuf, p.B, s.keys, (uint32_t)rid, lane};
        trace_path(s, p.T, p.L, p.depth, dr, p.in[0][lane], p.in[1][lane], p.in[2][lane],
                   p.in[3][lane], p.in[4][lane], p.in[5][lane],
                   tot_r, tot_g, tot_b, cnt);
      } else if (p.spp_loop == 1) {
        // rid is the absolute sample id; the stratum comes in sx, sy
        stratum_ray(p.cam, s, (uint32_t)rid, p.in[0][lane], p.in[1][lane],
                    p.in[2][lane], p.in[3][lane], o, d);
        const Draws dr{p.ubuf, p.B, s.keys, (uint32_t)rid, lane};
        trace_path(s, p.T, p.L, p.depth, dr, o[0], o[1], o[2], d[0], d[1], d[2],
                   tot_r, tot_g, tot_b, cnt);
      } else {
        // rid is the pixel id; sample ids pix*spp + s walk the strata in
        // order and each sample's radiance is flushed into the pixel total
        // in stratum order (the float-add order of per-stratum launches)
        const int S = p.sqrt_spp;
        const uint32_t spp = (uint32_t)(S * S);
        for (uint32_t st = 0; st < spp; ++st) {
          const uint32_t ridu = (uint32_t)rid * spp + st;
          stratum_ray(p.cam, s, ridu, p.in[0][lane], p.in[1][lane],
                      (float)(st % (uint32_t)S), (float)(st / (uint32_t)S), o, d);
          const Draws dr{p.ubuf, p.B, s.keys, ridu, lane};
          trace_path(s, p.T, p.L, p.depth, dr, o[0], o[1], o[2], d[0], d[1], d[2],
                     sr, sg, sb, cnt);
          tot_r = tot_r + sr;
          tot_g = tot_g + sg;
          tot_b = tot_b + sb;
        }
      }
    }
    p.out_r[lane] = tot_r;
    p.out_g[lane] = tot_g;
    p.out_b[lane] = tot_b;
  }

  // exact counters: warp sums, one 64-bit atomic per warp and counter
  for (int off = 16; off > 0; off >>= 1) {
    cnt.rays += __shfl_down_sync(0xffffffffu, cnt.rays, off);
    cnt.tests += __shfl_down_sync(0xffffffffu, cnt.tests, off);
    cnt.hits += __shfl_down_sync(0xffffffffu, cnt.hits, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (cnt.rays) atomicAdd(&p.counters[0], cnt.rays);
    if (cnt.tests) atomicAdd(&p.counters[1], cnt.tests);
    if (cnt.hits) atomicAdd(&p.counters[2], cnt.hits);
  }
}

}  // namespace bpt

extern "C" {

// Launches the megakernel on `stream`; returns cudaGetLastError() after the
// launch (0 = launched).  All pointers are device pointers.
int bpt_pt_megakernel(int pixels, int B, int T, int L, int depth,
                      int spp_loop, int sqrt_spp, const float* tri,
                      const float* mat, const float* lgt,
                      const uint32_t* keys, const float* cam,
                      const float* in0, const float* in1, const float* in2,
                      const float* in3, const float* in4, const float* in5,
                      const int* rid, const float* ubuf, float* out_r,
                      float* out_g, float* out_b,
                      unsigned long long* counters, void* stream) {
  bpt::Params p;
  p.pixels = pixels;
  p.B = B;
  p.T = T;
  p.L = L;
  p.depth = depth;
  p.spp_loop = spp_loop;
  p.sqrt_spp = sqrt_spp;
  p.tri = tri;
  p.mat = mat;
  p.lgt = lgt;
  p.keys = keys;
  p.cam = cam;
  p.in[0] = in0;
  p.in[1] = in1;
  p.in[2] = in2;
  p.in[3] = in3;
  p.in[4] = in4;
  p.in[5] = in5;
  p.rid = rid;
  p.ubuf = ubuf;
  p.out_r = out_r;
  p.out_g = out_g;
  p.out_b = out_b;
  p.counters = counters;
  const int grid = (B + bpt::BLOCK - 1) / bpt::BLOCK;
  if (grid > 0) {
    bpt::pt_megakernel<<<grid, bpt::BLOCK, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* bpt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
