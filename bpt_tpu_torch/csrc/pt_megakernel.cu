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
// shape.  Counters are exact 64-bit integers.  The bounce itself is
// pt_shade.cuh's pt_bounce, which the per-bounce wave kernel shares.
#include <cuda_runtime.h>

#include <cstdint>

#include "pt_shade.cuh"

namespace bpt {

constexpr int MAX_TRIS = 512;
constexpr int TRI_STRIDE = 13;  // v0(3) e1(3) e2(3) n(3) mat(1)
constexpr int NKEYS = 2 * NU + 4;
constexpr int BLOCK = 128;

struct Params {
  int pixels;    // 0: rays given (o, d); 1: in-kernel raygen from pixels
  int B, T, L, depth;
  int spp_loop;  // pixels mode: > 1 walks all strata of a pixel
  int sqrt_spp;
  const float* tri;   // [MAX_TRIS * 13]
  const float* mat;   // [MAX_MATS * 6]
  const float* lgt;   // [LGT_TAB] (background at the tail)
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
  float lgt[LGT_TAB];
  uint32_t keys[NKEYS];
};

struct Counts {
  unsigned long long rays = 0, tests = 0, hits = 0;
};

// The megakernel's hit provider: strict t < t_best over every triangle in
// shared memory keeps the first of equal hits.
struct BruteClosest {
  const float* tri;
  int T;
  Counts& cnt;

  __device__ __forceinline__ Hit operator()(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
    cnt.tests += (unsigned long long)T;
    float t_hit = __int_as_float(0x7f800000);  // +inf
    int best = -1;
    for (int ti = 0; ti < T; ++ti) {
      bool valid;
      const float t = moller_trumbore(ox, oy, oz, dx, dy, dz,
                                      &tri[ti * TRI_STRIDE], valid);
      if (valid && t >= T_MIN && t < t_hit) {
        t_hit = t;
        best = ti;
      }
    }
    if (best >= 0) cnt.hits += 1;
    return Hit{best, t_hit};
  }

  __device__ __forceinline__ void surface(int k, float& gnx, float& gny,
                                          float& gnz, int& mat) const {
    const float* tr = &tri[k * TRI_STRIDE];
    gnx = tr[9];
    gny = tr[10];
    gnz = tr[11];
    mat = (int)tr[12];
  }
};

// One path from (o, d) to termination: make_bounce's estimator
// (pt_kernel.py:230-675) bounce after bounce.
__device__ void trace_path(const Tables& s, int T, int L, int depth,
                           const Draws dr, float cox, float coy, float coz,
                           float cdx, float cdy, float cdz,
                           float& ar, float& ag, float& ab, Counts& cnt) {
  PathState st{cox, coy, coz, cdx, cdy, cdz, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
  BruteClosest closest{s.tri, T, cnt};
  bool alive = true;
  for (int b = 0; b < depth; ++b) {
    cnt.rays += 1;
    if (!pt_bounce(s.mat, s.lgt, L, dr, b, closest, st)) {
      alive = false;
      break;
    }
  }
  // depth-exhausted entry still counts (camera.h:256)
  if (alive) cnt.rays += 1;
  ar = st.ar;
  ag = st.ag;
  ab = st.ab;
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

// Five blocks an SM (20 warps): the cap holds the kernel to 96 registers
// and a 32-byte stack.  Uncapped, the shared bounce takes 110 registers and
// leaves 4 blocks, which measured 9-18% slower at 512x512 x 16 spp
// (tools/ab_pt_megakernel.py).
__global__ void __launch_bounds__(BLOCK, 5) pt_megakernel(const Params p) {
  __shared__ Tables s;
  for (int k = threadIdx.x; k < p.T * TRI_STRIDE; k += blockDim.x) s.tri[k] = p.tri[k];
  for (int k = threadIdx.x; k < MAX_MATS * MAT_STRIDE; k += blockDim.x) s.mat[k] = p.mat[k];
  for (int k = threadIdx.x; k < LGT_TAB; k += blockDim.x) s.lgt[k] = p.lgt[k];
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
