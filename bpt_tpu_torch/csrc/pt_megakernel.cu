// Fused PT megakernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of bpt_tpu/ops/pallas/pt_kernel.py
// (_pt_kernel_impl + make_bounce, launched by pt_megakernel and
// pt_megakernel_pixels): raygen, every spp stratum, every bounce, the
// closest hits, lambertian / metal / dielectric / light / isotropic
// shading, the 50/50 light/BSDF mixture NEE and the threefry stream, in one
// launch.  Untextured float32 scenes with 16 materials and 16 lights, and
// at most 4 constant-density volumes over 64 boundary triangles.  Two
// modes, as the Pallas kernel has (use_clusters): a scene of at most 512
// triangles sweeps them all, brute force, from shared memory
// (pt_megakernel); a larger one walks its BVH (pt_megakernel_walk, the
// counterpart of the clustered mode's make_clustered_closest,
// pt_kernel.py:726-772).
//
// What bounds it on the H100.  Brute mode: FP32 issue and warp divergence,
// not memory.  A lane reads its inputs once and writes three floats; per
// bounce it runs ~40 flops for each of the T triangles and each of the L
// lights, and paths end after a data-dependent number of bounces (2.73 on
// average on the cornell box at depth 10, 10% of them past 4), so the
// lanes of a warp finish at different times: a thread a pixel that ran
// its strata one after another, the warp reconverging after each, took
// 113 bounce iterations a warp for 44 useful ones (PERF.md §6).
// Walk mode: the walk's dependent node loads and the divergence of the
// lanes' node sequences (pt_wave.cu), on top of the paths' own divergence.
//
// Design: both modes run one sample a work item on a persistent grid
// (walk_sched.cuh).  The brute mode's lanes run a flat bounce loop, the
// TPU kernel's persistent-sample lanes without their lockstep: an
// iteration is one bounce of each busy lane's sample, a lane whose path
// ends writes its radiance and is free, and the warp takes new samples
// for its free lanes (warp_take_n) once PT_REFILL of them are free, so a
// warp is held for one bounce at a time, not for its longest path; the
// triangle sweep stays converged, every lane sweeping every triangle.
// The walk mode's warps take 32 samples at a time, since its samples'
// walk chains differ far more than a bounce.  In pixels mode each sample's
// radiance goes to a stratum-major buffer, which the wrapper adds into
// the pixel totals in stratum order (strata_sum.cu).  Each path runs to
// termination with real branches instead of masked selects, and the
// material / light tables (and in brute mode the triangle table) sit in
// shared memory, where every thread of a converged warp reads the same
// word (a broadcast).  The walk reads the BVH from global memory through
// the read-only path, so the mode has no table budget (bpt_tpu's 480 KB
// single-table limit, clusters.py:92-102, is a TPU SMEM bound).  Direct mat_tab[mat_id] indexing replaces the TPU
// kernel's masked scans.  Draws are threefry2x32 keyed per slot with the
// bounce in the counter and the absolute sample id pix * spp + k, so a
// sample's stream does not depend on the lane or launch that runs it.
// Counters are exact 64-bit integers: rays, then the hit provider's node
// visits, box hits, triangle tests and accepted tests (bvh_walk.cuh).  The
// bounce itself is pt_shade.cuh's pt_bounce, which the per-bounce wave
// kernel shares.
//
// Volumes: a scene with constant-density volumes launches the _vol
// kernels, the same bodies instantiated with VOLS, which stage the volume
// tables in shared memory and run volume.cuh's free-flight override after
// each closest hit; a bounce then has NU + V slots, the V free-flight
// draws last, and the raygen keys follow them.  The kernels of a scene
// without volumes are the bodies without VOLS, compiled as before.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "pt_shade.cuh"
#include "walk_sched.cuh"

namespace bpt {

constexpr int MAX_TRIS = 512;
constexpr int NKEYS = 2 * NU + 4;
constexpr int NKEYS_VOL = 2 * (NU + MAX_VOLS) + 4;
constexpr int BLOCK = 128;
// Blocks an SM for the walk mode: the brute mode's cap of 5 holds a kernel
// to 96 registers, which the walk's extra state would spill.
constexpr int WALK_MIN_BLOCKS = 4;

struct Params {
  int pixels;    // 0: rays given (o, d); 1: in-kernel raygen from pixels
  int B, T, L, depth;
  int spp_loop;  // pixels mode: > 1 runs the strata of a pixel
  int sqrt_spp;
  int k0, nk;    // pixels mode, spp_loop > 1: the launch's strata [k0, k0 + nk)
  // the work counter, zeroed by the wrapper: walk mode int (warp_take),
  // brute mode unsigned long long (warp_take_n)
  void* next;
  const float* tri;   // brute mode: [MAX_TRIS * 13]
  Bvh g;              // walk mode: the BVH (g.N > 0)
  const int* mat_id;  // walk mode: [T]
  const float* mat;   // [MAX_MATS * 6]
  const float* lgt;   // [LGT_TAB] (background at the tail)
  // [2*(NU+V)] slot keys (+4 jitter words in pixels mode)
  const uint32_t* keys;
  const float* cam;   // [13] pixel00, du, dv, center, 1/sqrt_spp
  // rays mode: ox, oy, oz, dx, dy, dz; pixels mode: i, j, sx, sy
  const float* in[6];
  const int* rid;     // [B] ray / sample / pixel id; < 0 = inactive lane
  const float* ubuf;  // optional [depth*(NU+V), B] injected uniforms
  int V, VT;          // volumes and their boundary triangles
  const float* vol;   // [MAX_VOL_TRIS * 10] (pack_vol_tables)
  const float* volm;  // [MAX_VOLS * 2]
  // [B], or in pixels mode with spp_loop > 1 [nk][B]: the radiance of
  // sample (lane, k) at (k - k0) * B + lane
  float* out_r;
  float* out_g;
  float* out_b;
  unsigned long long* counters;  // [5] rays, node visits, box hits, tri tests, tri hits
};

// The shading tables and keys every block stages in shared memory; the
// brute mode adds the triangle table, a volume scene the volume tables.
template <int NK>
struct TablesOf {
  float mat[MAX_MATS * MAT_STRIDE];
  float lgt[LGT_TAB];
  uint32_t keys[NK];
};
using Tables = TablesOf<NKEYS>;
using TablesVol = TablesOf<NKEYS_VOL>;

// Slots a bounce draws: NU, and a volume scene's V free-flight slots.
template <bool VOLS>
__device__ __forceinline__ int slots(const Params& p) {
  return VOLS ? NU + p.V : NU;
}

// A lane's counters: traced rays, and the hit provider's node visits, box
// hits, triangle tests and accepted tests, which it adds to the base.
struct Counts : TraceCounts {
  unsigned long long rays = 0;
};

// One path from its start `st` to termination: make_bounce's estimator
// (pt_kernel.py:230-675) bounce after bounce, its closest hits from the
// provider (bvh_walk.cuh: WalkHit over Counts), passed by value; the rays
// count in the provider's counters.
template <bool VOLS, class Tab, class Closest>
__device__ void trace_path(const Tab& s, const VolTables* vol, int L, int depth,
                           const Draws dr, PathState st, Closest closest, float& ar,
                           float& ag, float& ab) {
  bool alive = true;
  for (int b = 0; b < depth; ++b) {
    closest.c.rays += 1;
    if (!pt_bounce<VOLS>(s.mat, s.lgt, L, dr, b, closest, st, vol)) {
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

template <class Tab>
__device__ __forceinline__ void stratum_ray(const float* c, const Tab& s, int nu,
                                            uint32_t ridu, float i, float j,
                                            float sx, float sy, float* o,
                                            float* d) {
  // get_ray (camera.h:199-213): stratified jitter from the raygen key after
  // the nu slot keys (pt_kernel.py:816-833), unnormalized direction
  uint32_t b1 = ridu, b2 = 0u;
  threefry2x32(s.keys[2 * nu], s.keys[2 * nu + 1], b1, b2);
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

template <bool VOLS, class Tab>
__device__ __forceinline__ void stage_tables(const Params& p, Tab& s) {
  for (int k = threadIdx.x; k < MAX_MATS * MAT_STRIDE; k += blockDim.x) s.mat[k] = p.mat[k];
  for (int k = threadIdx.x; k < LGT_TAB; k += blockDim.x) s.lgt[k] = p.lgt[k];
  const int nkeys = 2 * slots<VOLS>(p) + (p.pixels ? 4 : 0);
  for (int k = threadIdx.x; k < nkeys; k += blockDim.x) s.keys[k] = p.keys[k];
}

// A sample in flight: its path, the bounce it is at and the id its draws
// are keyed by.
struct Flight {
  PathState st;
  uint32_t ridu;
  int b;
};

// Starts sample k of lane (rays mode: the lane's ray; pixels mode: the
// stratum k of its pixel, or with spp_loop 1 the stratum in sx, sy).
template <bool VOLS, class Tab>
__device__ __forceinline__ void start_sample(const Params& p, const Tab& s,
                                             int lane, int rid, uint32_t k,
                                             Flight& f) {
  f.b = 0;
  f.st.tr = f.st.tg = f.st.tb = 1.0f;
  f.st.ar = f.st.ag = f.st.ab = 0.0f;
  if (!p.pixels) {
    f.ridu = (uint32_t)rid;
    f.st.ox = p.in[0][lane];
    f.st.oy = p.in[1][lane];
    f.st.oz = p.in[2][lane];
    f.st.dx = p.in[3][lane];
    f.st.dy = p.in[4][lane];
    f.st.dz = p.in[5][lane];
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
  stratum_ray(p.cam, s, slots<VOLS>(p), ridu, p.in[0][lane], p.in[1][lane], sx, sy, o, d);
  f.ridu = ridu;
  f.st.ox = o[0];
  f.st.oy = o[1];
  f.st.oz = o[2];
  f.st.dx = d[0];
  f.st.dy = d[1];
  f.st.dz = d[2];
}

// One sample of `lane` (start_sample) traced to termination with the
// provider `closest` (the walk mode).
template <bool VOLS, class Tab, class Closest>
__device__ __forceinline__ void sample(const Params& p, const Tab& s,
                                       const VolTables* vol, int lane, int rid,
                                       uint32_t k, Closest closest, float& r,
                                       float& g, float& b) {
  Flight f;
  start_sample<VOLS>(p, s, lane, rid, k, f);
  const Draws dr{p.ubuf, p.B, s.keys, f.ridu, lane, slots<VOLS>(p)};
  trace_path<VOLS>(s, vol, p.L, p.depth, dr, f.st, closest, r, g, b);
}

// exact counters: warp sums, one 64-bit atomic per warp and counter
__device__ __forceinline__ void flush_counts(const Params& p, const Counts& c) {
  warp_add(c.rays, &p.counters[0]);
  warp_add(c.nodes, &p.counters[1]);
  warp_add(c.boxes, &p.counters[2]);
  warp_add(c.tests, &p.counters[3]);
  warp_add(c.hits, &p.counters[4]);
}

// A warp refills when at least PT_REFILL of its lanes are free: chosen on
// the card (PERF.md §6).
constexpr int PT_REFILL = 4;
// The brute mode's register bound, __launch_bounds__(BLOCK, BRUTE_BLOCKS):
// the kernel takes fewer registers, and its persistent grid holds as many
// blocks an SM as the occupancy query finds (PERF.md §6).
constexpr int BRUTE_BLOCKS = 5;

// The brute mode's lanes: a persistent grid whose warps refill their free
// lanes (walk_sched.cuh::warp_take_n), each lane running one bounce of
// its sample an iteration: the TPU kernel's persistent-sample lanes
// (pt_kernel.py:838-928) without the lockstep.  A work item is a sample:
// item w = kk * B + lane is stratum k0 + kk of lane (rays mode, and pixels
// mode with spp_loop 1: kk = 0), its radiance written to out[w]: a
// stratum-major [nk][B], which the wrapper adds into the pixel totals in
// stratum order.
template <bool VOLS, class Tab, class Closest>
__device__ __forceinline__ void brute_lanes(const Params& p, const Tab& s,
                                            const VolTables* vol, Closest closest,
                                            unsigned long long* work) {
  const long long n = (long long)p.B * p.nk;
  int item = -1;  // the lane's work item; -1 when the lane is free
  int lane = 0;
  Flight f;
  bool more = true;  // the launch's counter has items left (warp-uniform)
  for (;;) {
    __syncwarp();
    unsigned busy = __ballot_sync(0xffffffffu, item >= 0);
    const int n_free = 32 - __popc(busy);
    if (more && n_free >= PT_REFILL) {
      const long long base = warp_take_n(work, n_free);
      more = base + n_free < n;
      const long long w = base + rank_in(~busy);
      if (item < 0 && w < n) {
        const int kk = (int)(w / p.B);
        lane = (int)(w - (long long)kk * p.B);
        const int rid = p.rid[lane];
        if (rid < 0) {  // an inactive lane writes 0 and stays free
          p.out_r[w] = 0.0f;
          p.out_g[w] = 0.0f;
          p.out_b[w] = 0.0f;
        } else {
          item = (int)w;
          start_sample<VOLS>(p, s, lane, rid, (uint32_t)(p.k0 + kk), f);
        }
      }
      busy = __ballot_sync(0xffffffffu, item >= 0);
    }
    if (!busy) {
      if (!more) break;
      continue;
    }
    if (item < 0) continue;
    bool alive = true;
    if (f.b < p.depth) {  // depth 0: the path ends at its entry
      closest.c.rays += 1;
      const Draws dr{p.ubuf, p.B, s.keys, f.ridu, lane, slots<VOLS>(p)};
      alive = pt_bounce<VOLS>(s.mat, s.lgt, p.L, dr, f.b, closest, f.st, vol);
      f.b += 1;
      if (alive && f.b < p.depth) continue;
    }
    // depth-exhausted entry still counts (camera.h:256)
    if (alive) closest.c.rays += 1;
    p.out_r[item] = f.st.ar;
    p.out_g[item] = f.st.ag;
    p.out_b[item] = f.st.ab;
    item = -1;
  }
}

// Brute mode: the triangle table in shared memory, where every thread of a
// converged warp reads the same word, on a persistent grid (brute_lanes).
__global__ void __launch_bounds__(BLOCK, BRUTE_BLOCKS) pt_megakernel(const Params p) {
  __shared__ Tables s;
  __shared__ float s_tri[MAX_TRIS * TRI_STRIDE];
  for (int k = threadIdx.x; k < p.T * TRI_STRIDE; k += blockDim.x) s_tri[k] = p.tri[k];
  stage_tables<false>(p, s);
  __syncthreads();
  Counts cnt;
  brute_lanes<false>(p, s, nullptr, BruteHit<Counts>{s_tri, p.T, cnt},
                     (unsigned long long*)p.next);
  flush_counts(p, cnt);
}

// The brute mode on a scene with volumes.
__global__ void __launch_bounds__(BLOCK, BRUTE_BLOCKS) pt_megakernel_vol(const Params p) {
  __shared__ TablesVol s;
  __shared__ VolTables sv;
  __shared__ float s_tri[MAX_TRIS * TRI_STRIDE];
  for (int k = threadIdx.x; k < p.T * TRI_STRIDE; k += blockDim.x) s_tri[k] = p.tri[k];
  stage_tables<true>(p, s);
  stage_volumes(p.vol, p.volm, p.V, p.VT, sv);
  __syncthreads();
  Counts cnt;
  brute_lanes<true>(p, s, &sv, BruteHit<Counts>{s_tri, p.T, cnt},
                    (unsigned long long*)p.next);
  flush_counts(p, cnt);
}

// Walk mode: each closest hit walks the BVH in global memory (the clustered
// mode of bpt_tpu's megakernel, use_clusters: more than 512 triangles).  A
// persistent grid, one sample a work item (walk_sched.cuh); each sample's
// radiance is written on its own, and the wrapper adds a pixel's strata.
template <bool VOLS, class Tab>
__device__ __forceinline__ void walk_samples(const Params& p, const Tab& s,
                                             const VolTables* vol) {
  Counts cnt;
  const WalkHit<Counts> closest{p.g, p.mat_id, cnt};
  const int n = p.B * p.nk;
  for (;;) {
    const int base = warp_take((int*)p.next);
    if (base >= n) break;
    const int item = base + (threadIdx.x & 31);
    if (item >= n) continue;
    const int lane = item / p.nk;
    const int kk = item - lane * p.nk;
    const int rid = p.rid[lane];
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (rid >= 0) sample<VOLS>(p, s, vol, lane, rid, (uint32_t)(p.k0 + kk), closest, r, g, b);
    const size_t o = (size_t)kk * p.B + lane;
    p.out_r[o] = r;
    p.out_g[o] = g;
    p.out_b[o] = b;
  }
  flush_counts(p, cnt);
}

__global__ void __launch_bounds__(BLOCK, WALK_MIN_BLOCKS) pt_megakernel_walk(const Params p) {
  __shared__ Tables s;
  stage_tables<false>(p, s);
  __syncthreads();
  walk_samples<false>(p, s, nullptr);
}

// The walk mode on a scene with volumes.
__global__ void __launch_bounds__(BLOCK, WALK_MIN_BLOCKS) pt_megakernel_walk_vol(const Params p) {
  __shared__ TablesVol s;
  __shared__ VolTables sv;
  stage_tables<true>(p, s);
  stage_volumes(p.vol, p.volm, p.V, p.VT, sv);
  __syncthreads();
  walk_samples<true>(p, s, &sv);
}

}  // namespace bpt

extern "C" {

// Launches the megakernel on `stream` on `grid` persistent blocks with the
// work counter `next` (zeroed by the caller); returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a table
// size or work split the kernel does not take.  N > 0 selects the walk
// mode over the BVH (nodes, tris, mat_id; tri unused; `next` an int), N ==
// 0 the brute mode over tri (T <= 512; `next` an unsigned long long).  A
// sample a work item: in pixels mode with spp_loop > 1 the strata
// [k0, k0 + nk), else k0 = 0, nk = 1.  V > 0 volumes over VT boundary
// triangles (vol, volm: pack_vol_tables) select the _vol kernels; keys and
// ubuf then hold NU + V slots a bounce.  All pointers are device pointers.
int bpt_pt_megakernel(int pixels, int B, int T, int L, int depth,
                      int spp_loop, int sqrt_spp, int N, int k0, int nk,
                      int grid, const float* tri, const float* nodes,
                      const float* tris, const int* mat_id, const float* mat,
                      const float* lgt, const uint32_t* keys, const float* cam,
                      const float* in0, const float* in1, const float* in2,
                      const float* in3, const float* in4, const float* in5,
                      const int* rid, const float* ubuf, float* out_r,
                      float* out_g, float* out_b,
                      unsigned long long* counters, void* next, int V, int VT,
                      const float* vol, const float* volm, void* stream) {
  const bool strata = pixels && spp_loop > 1;
  if (N < 0 || (N == 0 && (T < 0 || T > bpt::MAX_TRIS)) || grid < 1 || nk < 1 || k0 < 0 ||
      V < 0 || V > bpt::MAX_VOLS || VT < 0 || VT > bpt::MAX_VOL_TRIS || (V > 0 && VT < 1) ||
      (!strata && (k0 != 0 || nk != 1)) || (strata && k0 + nk > sqrt_spp * sqrt_spp) ||
      (long long)B * nk > (1LL << 30)) {
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
  p.V = V;
  p.VT = VT;
  p.vol = vol;
  p.volm = volm;
  if (B > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (N > 0 && V > 0) {
      bpt::pt_megakernel_walk_vol<<<grid, bpt::BLOCK, 0, st>>>(p);
    } else if (N > 0) {
      bpt::pt_megakernel_walk<<<grid, bpt::BLOCK, 0, st>>>(p);
    } else if (V > 0) {
      bpt::pt_megakernel_vol<<<grid, bpt::BLOCK, 0, st>>>(p);
    } else {
      bpt::pt_megakernel<<<grid, bpt::BLOCK, 0, st>>>(p);
    }
  }
  return (int)cudaGetLastError();
}

// Blocks of the PT megakernel the current device holds at once (its
// persistent grid), or a negative CUDA error code: pt_megakernel_walk if
// walk, else pt_megakernel (the brute mode); their volume kernels if vols.
int bpt_pt_blocks(int walk, int vols) {
  static int walk_cache[2][64], vol_cache[64], cache[64];
  if (walk)
    return bpt::resident_blocks(vols ? bpt::pt_megakernel_walk_vol : bpt::pt_megakernel_walk,
                                bpt::BLOCK, walk_cache[vols != 0], 64);
  if (vols) return bpt::resident_blocks(bpt::pt_megakernel_vol, bpt::BLOCK, vol_cache, 64);
  return bpt::resident_blocks(bpt::pt_megakernel, bpt::BLOCK, cache, 64);
}

const char* bpt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
