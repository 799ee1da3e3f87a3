// Fused PT megakernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of bpt_tpu/ops/pallas/pt_kernel.py
// (_pt_kernel_impl + make_bounce, launched by pt_megakernel and
// pt_megakernel_pixels): raygen, every spp stratum, every bounce, the
// closest hits, lambertian / metal / dielectric / light / isotropic
// shading, the 50/50 light/BSDF mixture NEE and the threefry stream, in one
// launch.  Untextured, volume-free float32 scenes with 16 materials and 16
// lights.  Two modes, as the Pallas kernel has (use_clusters): a scene of
// at most 512 triangles sweeps them all, brute force, from shared memory
// (pt_megakernel); a larger one walks its BVH (pt_megakernel_walk, the
// counterpart of the clustered mode's make_clustered_closest,
// pt_kernel.py:726-772).
//
// What bounds it on the H100.  Brute mode: FP32 issue and warp divergence,
// not memory.  A lane reads its inputs once and writes three floats; per
// bounce it runs ~40 flops for each of the T triangles and each of the L
// lights, and paths end after a data-dependent number of bounces (2.7 on
// average on the cornell box at depth 10), so the lanes of a warp finish
// at different times.  Walk mode: the walk's dependent node loads and the
// divergence of the lanes' node sequences (pt_wave.cu), on top of the
// paths' own divergence.
//
// Design: the brute mode takes one thread per lane (a ray, or a pixel that
// walks all its strata one after another: the persistent-sample idea of
// the TPU kernel without its lockstep); the walk mode one lane per sample
// on a persistent grid (walk_sched.cuh), since its samples' walk chains
// differ in length far more.  Each path runs to termination with real
// branches instead of masked selects, and the material / light tables (and in brute mode
// the triangle table) sit in shared memory, where every thread of a
// converged warp reads the same word (a broadcast).  The walk reads the
// BVH from global memory through the read-only path, so the mode has no
// table budget (bpt_tpu's 480 KB single-table limit, clusters.py:92-102,
// is a TPU SMEM bound).  Direct mat_tab[mat_id] indexing replaces the TPU
// kernel's masked scans.  Draws are threefry2x32 keyed per slot with the
// bounce in the counter, so a lane's stream does not depend on launch
// shape.  Counters are exact 64-bit integers: rays, then the hit
// provider's node visits, box hits, triangle tests and accepted tests
// (bvh_walk.cuh).  The bounce itself is pt_shade.cuh's pt_bounce, which
// the per-bounce wave kernel shares.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "pt_shade.cuh"
#include "walk_sched.cuh"

namespace bpt {

constexpr int MAX_TRIS = 512;
constexpr int NKEYS = 2 * NU + 4;
constexpr int BLOCK = 128;
// Blocks an SM for the walk mode: the brute mode's cap of 5 holds a kernel
// to 96 registers, which the walk's extra state would spill.
constexpr int WALK_MIN_BLOCKS = 4;

struct Params {
  int pixels;    // 0: rays given (o, d); 1: in-kernel raygen from pixels
  int B, T, L, depth;
  int spp_loop;  // pixels mode: > 1 runs the strata of a pixel
  int sqrt_spp;
  int k0, nk;    // walk mode, spp_loop > 1: the launch's strata [k0, k0 + nk)
  int* next;     // walk mode: the work counter (walk_sched.cuh)
  const float* tri;   // brute mode: [MAX_TRIS * 13]
  Bvh g;              // walk mode: the BVH (g.N > 0)
  const int* mat_id;  // walk mode: [T]
  const float* mat;   // [MAX_MATS * 6]
  const float* lgt;   // [LGT_TAB] (background at the tail)
  const uint32_t* keys;  // [2*NU] slot keys (+4 jitter words in pixels mode)
  const float* cam;   // [13] pixel00, du, dv, center, 1/sqrt_spp
  // rays mode: ox, oy, oz, dx, dy, dz; pixels mode: i, j, sx, sy
  const float* in[6];
  const int* rid;     // [B] ray / sample / pixel id; < 0 = inactive lane
  const float* ubuf;  // optional [depth*NU, B] injected uniforms
  // [B], or in the walk mode's pixels mode with spp_loop > 1 [nk][B]: the
  // radiance of sample (lane, k) at (k - k0) * B + lane
  float* out_r;
  float* out_g;
  float* out_b;
  unsigned long long* counters;  // [5] rays, node visits, box hits, tri tests, tri hits
};

// The shading tables and keys every block stages in shared memory; the
// brute mode adds the triangle table.
struct Tables {
  float mat[MAX_MATS * MAT_STRIDE];
  float lgt[LGT_TAB];
  uint32_t keys[NKEYS];
};

// A lane's counters: traced rays, and the hit provider's node visits, box
// hits, triangle tests and accepted tests, which it adds to the base.
struct Counts : TraceCounts {
  unsigned long long rays = 0;
};

// One path from (o, d) to termination: make_bounce's estimator
// (pt_kernel.py:230-675) bounce after bounce, its closest hits from the
// provider (bvh_walk.cuh: BruteHit or WalkHit over Counts), passed by
// value; the rays count in the provider's counters.
template <class Closest>
__device__ void trace_path(const Tables& s, int L, int depth, const Draws dr,
                           float cox, float coy, float coz, float cdx,
                           float cdy, float cdz, Closest closest, float& ar,
                           float& ag, float& ab) {
  PathState st{cox, coy, coz, cdx, cdy, cdz, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
  bool alive = true;
  for (int b = 0; b < depth; ++b) {
    closest.c.rays += 1;
    if (!pt_bounce(s.mat, s.lgt, L, dr, b, closest, st)) {
      alive = false;
      break;
    }
  }
  // depth-exhausted entry still counts (camera.h:256)
  if (alive) closest.c.rays += 1;
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

__device__ __forceinline__ void stage_tables(const Params& p, Tables& s) {
  for (int k = threadIdx.x; k < MAX_MATS * MAT_STRIDE; k += blockDim.x) s.mat[k] = p.mat[k];
  for (int k = threadIdx.x; k < LGT_TAB; k += blockDim.x) s.lgt[k] = p.lgt[k];
  const int nkeys = p.pixels ? NKEYS : 2 * NU;
  for (int k = threadIdx.x; k < nkeys; k += blockDim.x) s.keys[k] = p.keys[k];
}

// One sample of `lane`: its ray (rays mode), its stratum (pixels mode with
// spp_loop 1: rid is the absolute sample id, the stratum in sx, sy), or
// stratum k of its pixel (spp_loop > 1: rid is the pixel id, the sample id
// pix*spp + k), traced with the provider `closest`.
template <class Closest>
__device__ __forceinline__ void sample(const Params& p, const Tables& s,
                                       int lane, int rid, uint32_t k,
                                       Closest closest, float& r, float& g,
                                       float& b) {
  if (!p.pixels) {
    const Draws dr{p.ubuf, p.B, s.keys, (uint32_t)rid, lane};
    trace_path(s, p.L, p.depth, dr, p.in[0][lane], p.in[1][lane], p.in[2][lane],
               p.in[3][lane], p.in[4][lane], p.in[5][lane], closest, r, g, b);
    return;
  }
  uint32_t ridu = (uint32_t)rid;
  float sx, sy;
  if (p.spp_loop > 1) {
    const uint32_t S = (uint32_t)p.sqrt_spp;
    ridu = ridu * (S * S) + k;
    sx = (float)(k % S);
    sy = (float)(k / S);
  } else {
    sx = p.in[2][lane];
    sy = p.in[3][lane];
  }
  float o[3], d[3];
  stratum_ray(p.cam, s, ridu, p.in[0][lane], p.in[1][lane], sx, sy, o, d);
  const Draws dr{p.ubuf, p.B, s.keys, ridu, lane};
  trace_path(s, p.L, p.depth, dr, o[0], o[1], o[2], d[0], d[1], d[2], closest,
             r, g, b);
}

// The brute mode's lane: its ray, or its pixel's strata one after another,
// each sample's radiance added into the pixel total in stratum order.
template <class Closest>
__device__ __forceinline__ void run_lane(const Params& p, const Tables& s,
                                         Closest closest) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.B) return;
  const int rid = p.rid[lane];
  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
  if (rid >= 0) {
    if (!p.pixels || p.spp_loop == 1) {
      sample(p, s, lane, rid, 0u, closest, tot_r, tot_g, tot_b);
    } else {
      const uint32_t spp = (uint32_t)(p.sqrt_spp * p.sqrt_spp);
      for (uint32_t k = 0; k < spp; ++k) {
        float sr, sg, sb;
        sample(p, s, lane, rid, k, closest, sr, sg, sb);
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
__device__ __forceinline__ void flush_counts(const Params& p, const Counts& c) {
  warp_add(c.rays, &p.counters[0]);
  warp_add(c.nodes, &p.counters[1]);
  warp_add(c.boxes, &p.counters[2]);
  warp_add(c.tests, &p.counters[3]);
  warp_add(c.hits, &p.counters[4]);
}

// Brute mode: the triangle table in shared memory, where every thread of a
// converged warp reads the same word.  Five blocks an SM (20 warps): the
// cap holds the kernel to 96 registers and a 32-byte stack.  Uncapped, the
// shared bounce takes 110 registers and leaves 4 blocks, which measured
// 9-18% slower at 512x512 x 16 spp (tools/ab_pt_megakernel.py).
__global__ void __launch_bounds__(BLOCK, 5) pt_megakernel(const Params p) {
  __shared__ Tables s;
  __shared__ float s_tri[MAX_TRIS * TRI_STRIDE];
  for (int k = threadIdx.x; k < p.T * TRI_STRIDE; k += blockDim.x) s_tri[k] = p.tri[k];
  stage_tables(p, s);
  __syncthreads();
  Counts cnt;
  run_lane(p, s, BruteHit<Counts>{s_tri, p.T, cnt});
  flush_counts(p, cnt);
}

// Walk mode: each closest hit walks the BVH in global memory (the clustered
// mode of bpt_tpu's megakernel, use_clusters: more than 512 triangles).  A
// persistent grid, one sample a work item (walk_sched.cuh); each sample's
// radiance is written on its own, and the wrapper adds a pixel's strata.
__global__ void __launch_bounds__(BLOCK, WALK_MIN_BLOCKS) pt_megakernel_walk(const Params p) {
  __shared__ Tables s;
  stage_tables(p, s);
  __syncthreads();
  Counts cnt;
  const WalkHit<Counts> closest{p.g, p.mat_id, cnt};
  const int n = p.B * p.nk;
  for (;;) {
    const int base = warp_take(p.next);
    if (base >= n) break;
    const int item = base + (threadIdx.x & 31);
    if (item >= n) continue;
    const int lane = item / p.nk;
    const int kk = item - lane * p.nk;
    const int rid = p.rid[lane];
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (rid >= 0) sample(p, s, lane, rid, (uint32_t)(p.k0 + kk), closest, r, g, b);
    const size_t o = (size_t)kk * p.B + lane;
    p.out_r[o] = r;
    p.out_g[o] = g;
    p.out_b[o] = b;
  }
  flush_counts(p, cnt);
}

}  // namespace bpt

extern "C" {

// Launches the megakernel on `stream`; returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a table size or work
// split the kernel does not take.  N > 0 selects the walk mode over the BVH
// (nodes, tris, mat_id; tri unused) on `grid` persistent blocks, with the
// work counter `next` and, in pixels mode with spp_loop > 1, the strata
// [k0, k0 + nk); N == 0 the brute mode over tri (T <= 512), a thread a
// lane.  All pointers are device pointers.
int bpt_pt_megakernel(int pixels, int B, int T, int L, int depth,
                      int spp_loop, int sqrt_spp, int N, int k0, int nk,
                      int grid, const float* tri, const float* nodes,
                      const float* tris, const int* mat_id, const float* mat,
                      const float* lgt, const uint32_t* keys, const float* cam,
                      const float* in0, const float* in1, const float* in2,
                      const float* in3, const float* in4, const float* in5,
                      const int* rid, const float* ubuf, float* out_r,
                      float* out_g, float* out_b,
                      unsigned long long* counters, int* next, void* stream) {
  const bool strata = pixels && spp_loop > 1;
  if (N < 0 || (N == 0 && (T < 0 || T > bpt::MAX_TRIS)) ||
      (N > 0 && (grid < 1 || nk < 1 || k0 < 0 || (!strata && (k0 != 0 || nk != 1)) ||
                 (strata && k0 + nk > sqrt_spp * sqrt_spp) ||
                 (long long)B * nk > (1LL << 30)))) {
    return (int)cudaErrorInvalidValue;
  }
  bpt::Params p;
  p.pixels = pixels;
  p.B = B;
  p.T = T;
  p.L = L;
  p.depth = depth;
  p.spp_loop = spp_loop;
  p.sqrt_spp = sqrt_spp;
  p.k0 = k0;
  p.nk = nk;
  p.next = next;
  p.tri = tri;
  p.g = bpt::Bvh{(const float4*)nodes, (const float4*)tris, N};
  p.mat_id = mat_id;
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
  if (B > 0) {
    if (N > 0) {
      bpt::pt_megakernel_walk<<<grid, bpt::BLOCK, 0, (cudaStream_t)stream>>>(p);
    } else {
      bpt::pt_megakernel<<<(B + bpt::BLOCK - 1) / bpt::BLOCK, bpt::BLOCK, 0,
                           (cudaStream_t)stream>>>(p);
    }
  }
  return (int)cudaGetLastError();
}

// Blocks of pt_megakernel_walk the current device holds at once (the walk
// mode's persistent grid), or a negative CUDA error code.
int bpt_pt_walk_blocks() {
  static int cache[64];
  return bpt::resident_blocks(bpt::pt_megakernel_walk, bpt::BLOCK, cache, 64);
}

const char* bpt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
