// Large-scene tracing for Hopper (sm_90a): the BVH closest and any hit,
// and the per-bounce PT wave kernel.
//
// closest_bvh replaces the Pallas kernel
// bpt_tpu/ops/pallas/cluster_wave.py::clustered_closest_ftb_pallas (the
// front-to-back clustered closest hit over (T_MIN, inf) with an active
// mask): out t (inf on a miss), tri (-1 on a miss), u, v.
// any_bvh replaces cluster_wave.py::clustered_any_ftb_pallas (the any hit
// over [T_MIN, tmax] of BDPT's connection shadow rays, tmax <= 0 marking a
// dead lane, early exit): out hit.
// bvh64<false> and bvh64<true> are their float64 counterparts, over each
// lane's own [tmin, tmax] and the Bvh64 tables (bvh_walk.cuh): bpt_tpu's
// Pallas kernels take float32 only, and it computes every float64 hit of a
// scene with a BVH with its jnp walks soa.bvh_closest / bvh_any, whose
// answers and counts these give (--f64 renders through the stratum loop).
// pt_wave_bounce replaces bpt_tpu/ops/pallas/pt_wave.py::_launch_bounce
// (_bounce_kernel): make_bounce's shade of one PT bounce per ray over the
// closest hits closest_bvh (or, on a scene without a BVH, closest_tri)
// wrote, with kernel-stream draws keyed by (ray id, bounce).  The wrapper
// launches closest_bvh over the state's rays first, or is given the hits.
// Like make_bounce, it writes the hit point into the origin of every live
// hit, a lane that ends on an emitter or at a mixture pdf of 0 included
// (pt_kernel.py:661-667): a textured light's texel is read there
// (ops/kernels/pt_wave.py::texel_stage).  pt_bounce, which the PT
// megakernel shares, leaves such a lane's origin alone; the write is here.
// On a scene with constant-density volumes the wrapper launches
// pt_wave_bounce_vol, the same shade with pt_shade.cuh's free-flight
// override (volume.cuh) after the given hit; it writes -2 - the phase
// material into the hit's tri where a lane scatters in a volume, the
// Pallas kernel's ti (pt_kernel.py:396-410), for the texel stage.
//
// What bounds them on the H100: the walk, not FP32 throughput and not
// device-memory bandwidth (one thread a ray, closest_bvh, pt_wave_bounce
// and any_bvh ran at 1.7%, 7.0% and 0.45% of their bounds).
// Each step of a lane's walk loads a 32-byte node whose address depends on
// the previous step's slab test, and the lanes of a warp follow different
// node sequences of different lengths: one thread a ray on a grid of B /
// 128 blocks kept a warp until its longest walk ended, the other lanes idle
// (light subpath rays: 20.7 ms at 1,048,576 lanes).  The scene (32 B a
// node, 48 B a triangle: about 3 MB + 4.4 MB for the 91k-triangle coffee
// stand-in) stays resident in the 50 MB L2 cache.
//
// Design.  closest_bvh and any_bvh run on a persistent grid (the blocks
// the card holds at once) whose warps refill their finished lanes: every
// STEPS steps of its lanes' walks a warp counts its free lanes, and at
// REFILL or more lane 0 takes as many consecutive rays from the launch's
// work counter (a slot of the wrapper's zeroed counters) with one atomic;
// each free lane takes the next by its rank among them, so the new rays'
// loads are neighbours.  A lane that comes in inactive (any_bvh: dead,
// tmax <= 0) writes its miss at once and stays free, so only live rays
// hold lanes: a BDPT shadow wave has a lane per (camera vertex, light
// vertex) pair and under 2% of them live.  A wave that sparse takes about
// as long as its longest walk, a chain of dependent node loads (PERF.md
// §6): claims of many lanes an atomic, sized to the live share a warp had
// seen, did not shorten it and left the live rays of a sparse closest-hit
// wave on too few warps.  The walk is wave_walk.cuh's: bvh_walk's visit
// order, arithmetic, accept rule and counts (so kernel and plain version
// take the same branch at every step and count the same node visits, box
// hits, triangle tests and accepted tests), with a slab test that leaves
// out the NaN checks for a ray whose origin and 1/d are finite.
// pt_wave_bounce shades one thread a lane over closest_bvh's hits of its
// state's rows: a kernel that both walks and shades holds the shade's
// registers through the walk, and at the occupancy that leaves it lost
// more than refilling gained (PERF.md §6).  Counters are exact 64-bit
// integers: a thread's sums over its rays, a warp's sum, one atomic a warp.  Also measured and left out
// (PERF.md §6): while-while traversal, where a lane at a leaf waits for
// the warp's other lanes to reach theirs; child-pair records, which test
// the right child from its parent's load when the left one misses.
//
// The float64 kernels bvh64<false> / bvh64<true> are the same refill loop
// over wave_walk.cuh::WaveWalk64, whose step is designed for the latency
// of a double step (one 64-byte node record, the ordered slab, early-out
// tests, no (u, v) in the loop, 32-bit lane counters flushed before they
// could wrap); the any hit refills at 16 free lanes.  76 / 74 registers
// without spills (float32: 58 / 56), each kernel's grid from its own
// occupancy query.  Also measured and left out for them (PERF.md §6):
// __launch_bounds__ minimum blocks (spills, no gain), an L1 prefetch of
// the next nodes and the leaf's rows (15% slower), node i + 1's record
// loaded ahead into registers (4% slower).
//
// any_bvh's walk is bvh_walk<true>'s: an any hit keeps its interval and
// stops after the first leaf with a hit, which makes its answer
// independent of the visit order.  The TPU layout
// (128-lane tiles, the cluster blocks and their DMA double buffer, the lane
// roll, the per-octant order table, the sort that parks dead lanes in tail
// tiles) does not carry over.  The shade is pt_shade.cuh's pt_bounce,
// shared with the PT megakernel; the material and light tables and the
// slot keys sit in shared memory.  Ray state is a [13, B] row-major f32
// array (origin, direction, throughput, radiance, alive:
// ops/kernels/pt_wave.py's STATE_ROWS) so a warp's access to one row is
// coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "pt_shade.cuh"
#include "wave_walk.cuh"

namespace bpt {

constexpr int WAVE_BLOCK = 128;

// pt_bounce's provider: the hit closest_bvh computed.
struct GivenHit {
  Bvh g;
  const int* mat_id;
  float t;
  int tri;

  __device__ __forceinline__ Hit operator()(float, float, float, float, float,
                                            float) {
    return Hit{tri, t};
  }

  __device__ __forceinline__ void surface(int k, float& gnx, float& gny,
                                          float& gnz, int& mat) const {
    surface_of(g, mat_id, k, gnx, gny, gnz, mat);
  }
};

struct ClosestParams {
  int B;
  Bvh g;
  int bounds_ok;  // no node bound is NaN (WaveWalk::fast)
  const float* o[3];
  const float* d[3];
  const unsigned char* active;  // [B] bool
  float* t;
  int* tri;
  float* u;
  float* v;
  unsigned long long* counters;  // [5] node visits, box hits, tri tests, tri hits; work
};

// The refill loop is written out in each of the two kernels: through one
// template that took the lanes' loads and stores as callbacks,
// closest_bvh kept 56 registers and spilled 8 B, and ran 3% slower
// (PERF.md §6).
__global__ void __launch_bounds__(WAVE_BLOCK) closest_bvh(const ClosestParams p) {
  TraceCounts c;
  WaveWalk<false> w;
  int r = -1;        // the lane's ray; -1 when the lane is free
  bool more = true;  // the launch's counter has rays left (warp-uniform)
  while (true) {
    __syncwarp();
    const unsigned busy = __ballot_sync(0xffffffffu, r >= 0);
    const int n_free = 32 - __popc(busy);
    if (more && n_free >= REFILL) {
      const long long base = warp_take_n(&p.counters[4], n_free);
      more = base + n_free < p.B;
      const long long k = base + rank_in(~busy);
      if (r < 0 && k < p.B) {
        if (p.active[k]) {
          r = (int)k;
          w.start(p.o[0][k], p.o[1][k], p.o[2][k], p.d[0][k], p.d[1][k], p.d[2][k], inf_f(),
                  p.bounds_ok);
        } else {  // an inactive lane misses without a walk
          p.t[k] = inf_f();
          p.tri[k] = -1;
          p.u[k] = 0.0f;
          p.v[k] = 0.0f;
        }
      }
      continue;
    }
    if (!busy) break;
    if (r >= 0) {
      for (int s = 0; s < STEPS; ++s) {
        if (w.step(p.g, c)) {
          p.t[r] = w.t();
          p.tri[r] = w.tri;
          p.u[r] = w.u;
          p.v[r] = w.v;
          r = -1;
          break;
        }
      }
    }
  }
  warp_add(c.nodes, &p.counters[0]);
  warp_add(c.boxes, &p.counters[1]);
  warp_add(c.tests, &p.counters[2]);
  warp_add(c.hits, &p.counters[3]);
}

struct AnyParams {
  int B;
  Bvh g;
  int bounds_ok;
  const float* o[3];
  const float* d[3];
  const float* tmax;             // [B]; <= 0 marks a dead lane
  unsigned char* hit;            // [B] bool
  unsigned long long* counters;  // [5] node visits, box hits, tri tests, tri hits; work
};

__global__ void __launch_bounds__(WAVE_BLOCK) any_bvh(const AnyParams p) {
  TraceCounts c;
  WaveWalk<true> w;
  int r = -1;
  bool more = true;
  while (true) {
    __syncwarp();
    const unsigned busy = __ballot_sync(0xffffffffu, r >= 0);
    const int n_free = 32 - __popc(busy);
    if (more && n_free >= REFILL) {
      const long long base = warp_take_n(&p.counters[4], n_free);
      more = base + n_free < p.B;
      const long long k = base + rank_in(~busy);
      if (r < 0 && k < p.B) {
        const float tmax = p.tmax[k];
        if (tmax > 0.0f) {
          r = (int)k;
          w.start(p.o[0][k], p.o[1][k], p.o[2][k], p.d[0][k], p.d[1][k], p.d[2][k], tmax,
                  p.bounds_ok);
        } else {  // a dead lane never reaches the root; the lane stays free
          p.hit[k] = 0;
        }
      }
      continue;
    }
    if (!busy) break;
    if (r >= 0) {
      for (int s = 0; s < STEPS; ++s) {
        if (w.step(p.g, c)) {
          p.hit[r] = w.tri >= 0;
          r = -1;
          break;
        }
      }
    }
  }
  warp_add(c.nodes, &p.counters[0]);
  warp_add(c.boxes, &p.counters[1]);
  warp_add(c.tests, &p.counters[2]);
  warp_add(c.hits, &p.counters[3]);
}

// The float64 closest hit (ANY = false: active, t, tri, u, v) or any hit
// (ANY = true: hit) over each lane's own [tmin, tmax].
struct Params64 {
  int B;
  Bvh64 g;
  int bounds_ord;  // every node bound finite and min <= max (WaveWalk64::ord)
  const double* o[3];
  const double* d[3];
  const double* tmin;           // [B]
  const double* tmax;           // [B]; any hit: <= 0 (or NaN) marks a dead lane
  const unsigned char* active;  // [B] bool
  double* t;
  int* tri;
  double* u;
  double* v;
  unsigned char* hit;            // [B] bool
  unsigned long long* counters;  // [5] node visits, box hits, tri tests, tri hits; work
};

// Adds a lane's counts into the 64-bit device counters and zeroes them.
__device__ __forceinline__ void flush_counts(TraceCounts32& c, unsigned long long* dst) {
  atomicAdd(&dst[0], (unsigned long long)c.nodes);
  atomicAdd(&dst[1], (unsigned long long)c.boxes);
  atomicAdd(&dst[2], (unsigned long long)c.tests);
  atomicAdd(&dst[3], (unsigned long long)c.hits);
  c = TraceCounts32{};
}

// closest_bvh's and any_bvh's refill loop over WaveWalk64, every STEPS
// steps.  The any hit's sparse shadow waves refill at 16 free lanes, the
// closest hit at REFILL (measured on the card, PERF.md §6).  As
// ops/soa.py::bvh_closest counts a masked lane (its tmax collapsed to 0,
// its root visit taken off again), an inactive closest lane whose tmin is
// above 0 misses at the root and counts nothing; one whose tmin is not
// walks [tmin, 0] less its root visit, which only a non-production
// interval gives.  A dead any-hit lane never reaches the root.
template <bool ANY>
__global__ void __launch_bounds__(WAVE_BLOCK) bvh64(const Params64 p) {
  constexpr int R = ANY ? 16 : REFILL;
  TraceCounts32 c;
  WaveWalk64<ANY> w;
  int r = -1;
  bool more = true;
  while (true) {
    __syncwarp();
    const unsigned busy = __ballot_sync(0xffffffffu, r >= 0);
    const int n_free = 32 - __popc(busy);
    if (more && n_free >= R) {
      const long long base = warp_take_n(&p.counters[4], n_free);
      more = base + n_free < p.B;
      const long long k = base + rank_in(~busy);
      if (r < 0 && k < p.B) {
        if constexpr (ANY) {
          const double tmax = p.tmax[k];
          if (tmax > 0.0) {
            r = (int)k;
            w.start(p.o[0][k], p.o[1][k], p.o[2][k], p.d[0][k], p.d[1][k], p.d[2][k],
                    p.tmin[k], tmax, p.bounds_ord);
          } else {
            p.hit[k] = 0;
          }
        } else {
          const bool live = p.active[k];
          const double tmin = p.tmin[k];
          if (live || !(tmin > 0.0)) {
            if (!live) c.nodes -= 1;  // (32 bits: the walk's root visit adds it back)
            r = (int)k;
            w.start(p.o[0][k], p.o[1][k], p.o[2][k], p.d[0][k], p.d[1][k], p.d[2][k], tmin,
                    live ? p.tmax[k] : 0.0, p.bounds_ord);
          } else {
            p.t[k] = inf_of<double>();
            p.tri[k] = -1;
            p.u[k] = 0.0;
            p.v[k] = 0.0;
          }
        }
      }
      continue;
    }
    if (!busy) break;
    if (r >= 0) {
      for (int s = 0; s < STEPS; ++s) {
        if (w.step(p.g, c)) {
          if constexpr (ANY) {
            p.hit[r] = w.tri >= 0;
          } else {
            double u, v;
            w.uv(p.g, u, v);
            p.t[r] = w.t();
            p.tri[r] = w.tri;
            p.u[r] = u;
            p.v[r] = v;
          }
          r = -1;
          if ((c.nodes | c.tests) >> 31) flush_counts(c, p.counters);
          break;
        }
      }
    }
  }
  warp_add(c.nodes, &p.counters[0]);
  warp_add(c.boxes, &p.counters[1]);
  warp_add(c.tests, &p.counters[2]);
  warp_add(c.hits, &p.counters[3]);
}

struct WaveParams {
  int B, L, bounce;
  Bvh g;
  const int* mat_id;    // [T]
  const float* mat;     // [MAX_MATS * 6]
  const float* lgt;     // [LGT_TAB]
  const uint32_t* keys; // [2 * (NU + V)] slot keys
  const float* in;      // [STATE_ROWS, B]
  const int* rid;       // [B]
  const float* hit_t;   // [B] closest_bvh's t
  // [B] closest_bvh's tri; with volumes a lane that scatters in one gets
  // -2 - its phase material (the Pallas kernel's ti, pt_kernel.py:396-410)
  int* hit_tri;
  float* out;           // [STATE_ROWS, B]
  unsigned long long* counters;  // [1] rays
  int V, VT;            // volumes and their boundary triangles
  const float* vol;     // [MAX_VOL_TRIS * 10] (pack_vol_tables)
  const float* volm;    // [MAX_VOLS * 2]
};

// The shade of one lane (VOLS: with the free-flight override over vol).
template <bool VOLS>
__device__ __forceinline__ void shade_lane(const WaveParams& p, const float* s_mat,
                                           const float* s_lgt, const uint32_t* s_keys,
                                           const VolTables* vol) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long rays = 0;
  if (lane < p.B) {
    const size_t B = (size_t)p.B;
    const float* in = p.in + lane;
    PathState s{in[0], in[B], in[2 * B], in[3 * B], in[4 * B], in[5 * B],
                in[6 * B], in[7 * B], in[8 * B], 0.0f, 0.0f, 0.0f};
    float rr = in[9 * B], rg = in[10 * B], rb = in[11 * B];
    bool alive = false;
    if (in[12 * B] > 0.5f) {
      rays = 1;
      const Draws dr{nullptr, p.B, s_keys, (uint32_t)p.rid[lane], lane,
                     VOLS ? NU + p.V : NU};
      GivenHit h{p.g, p.mat_id, p.hit_t[lane], p.hit_tri[lane]};
      int vmat = -1;
      alive = pt_bounce<VOLS>(s_mat, s_lgt, p.L, dr, p.bounce, h, s, vol, &vmat);
      if (VOLS && vmat >= 0) p.hit_tri[lane] = -2 - vmat;
      if (!alive && h.tri >= 0 && vmat < 0) {  // the path ended at a hit: its point
        // (-fmad=false: rounded as pt_bounce's px, one multiply, one add)
        s.ox = s.ox + h.t * s.dx;
        s.oy = s.oy + h.t * s.dy;
        s.oz = s.oz + h.t * s.dz;
      }
      // at most one bounce of a path adds radiance: rr + 0 elsewhere
      rr = rr + s.ar;
      rg = rg + s.ag;
      rb = rb + s.ab;
    }
    float* out = p.out + lane;
    out[0] = s.ox;
    out[B] = s.oy;
    out[2 * B] = s.oz;
    out[3 * B] = s.dx;
    out[4 * B] = s.dy;
    out[5 * B] = s.dz;
    out[6 * B] = s.tr;
    out[7 * B] = s.tg;
    out[8 * B] = s.tb;
    out[9 * B] = rr;
    out[10 * B] = rg;
    out[11 * B] = rb;
    out[12 * B] = alive ? 1.0f : 0.0f;
  }
  warp_add(rays, &p.counters[0]);
}

// The shade of a PT bounce, over the closest hits closest_bvh wrote.
__global__ void __launch_bounds__(WAVE_BLOCK) pt_wave_bounce(const WaveParams p) {
  __shared__ float s_mat[MAX_MATS * MAT_STRIDE];
  __shared__ float s_lgt[LGT_TAB];
  __shared__ uint32_t s_keys[2 * NU];
  for (int k = threadIdx.x; k < MAX_MATS * MAT_STRIDE; k += blockDim.x) s_mat[k] = p.mat[k];
  for (int k = threadIdx.x; k < LGT_TAB; k += blockDim.x) s_lgt[k] = p.lgt[k];
  for (int k = threadIdx.x; k < 2 * NU; k += blockDim.x) s_keys[k] = p.keys[k];
  __syncthreads();
  shade_lane<false>(p, s_mat, s_lgt, s_keys, nullptr);
}

// The same on a scene with volumes.
__global__ void __launch_bounds__(WAVE_BLOCK) pt_wave_bounce_vol(const WaveParams p) {
  __shared__ float s_mat[MAX_MATS * MAT_STRIDE];
  __shared__ float s_lgt[LGT_TAB];
  __shared__ uint32_t s_keys[2 * (NU + MAX_VOLS)];
  __shared__ VolTables sv;
  for (int k = threadIdx.x; k < MAX_MATS * MAT_STRIDE; k += blockDim.x) s_mat[k] = p.mat[k];
  for (int k = threadIdx.x; k < LGT_TAB; k += blockDim.x) s_lgt[k] = p.lgt[k];
  for (int k = threadIdx.x; k < 2 * (NU + p.V); k += blockDim.x) s_keys[k] = p.keys[k];
  stage_volumes(p.vol, p.volm, p.V, p.VT, sv);
  __syncthreads();
  shade_lane<true>(p, s_mat, s_lgt, s_keys, &sv);
}

inline int grid_of(int B) { return (B + WAVE_BLOCK - 1) / WAVE_BLOCK; }

// A refilling kernel's persistent grid over B lanes: the blocks the card
// holds at once, and no more than the lanes fill; a negative CUDA error
// code if the occupancy query fails.
template <class Kernel>
int refill_grid(Kernel kernel, int* cache, int B) {
  const int blocks = resident_blocks(kernel, WAVE_BLOCK, cache, 64);
  const int fill = grid_of(B);
  return blocks < 0 || blocks < fill ? blocks : fill;
}

inline int closest_grid(int B) {
  static int cache[64];
  return refill_grid(closest_bvh, cache, B);
}

inline int any_grid(int B) {
  static int cache[64];
  return refill_grid(any_bvh, cache, B);
}

template <bool ANY>
int bvh64_grid(int B) {
  static int cache[64];
  return refill_grid(bvh64<ANY>, cache, B);
}

}  // namespace bpt

extern "C" {

// Launch on `stream`; each returns cudaGetLastError() after the launch
// (0 = launched).  All pointers are device pointers.
int bpt_closest_bvh(int B, int N, int bounds_ok, const float* nodes,
                    const float* tris, const float* ox, const float* oy,
                    const float* oz, const float* dx, const float* dy,
                    const float* dz, const unsigned char* active, float* t,
                    int* tri, float* u, float* v, unsigned long long* counters,
                    void* stream) {
  bpt::ClosestParams p;
  p.B = B;
  p.g = bpt::Bvh{(const float4*)nodes, (const float4*)tris, N};
  p.bounds_ok = bounds_ok;
  p.o[0] = ox;
  p.o[1] = oy;
  p.o[2] = oz;
  p.d[0] = dx;
  p.d[1] = dy;
  p.d[2] = dz;
  p.active = active;
  p.t = t;
  p.tri = tri;
  p.u = u;
  p.v = v;
  p.counters = counters;
  if (B <= 0) return (int)cudaGetLastError();
  const int grid = bpt::closest_grid(B);
  if (grid < 0) return -grid;
  bpt::closest_bvh<<<grid, bpt::WAVE_BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int bpt_any_bvh(int B, int N, int bounds_ok, const float* nodes, const float* tris,
                const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const float* tmax, unsigned char* hit,
                unsigned long long* counters, void* stream) {
  bpt::AnyParams p;
  p.B = B;
  p.g = bpt::Bvh{(const float4*)nodes, (const float4*)tris, N};
  p.bounds_ok = bounds_ok;
  p.o[0] = ox;
  p.o[1] = oy;
  p.o[2] = oz;
  p.d[0] = dx;
  p.d[1] = dy;
  p.d[2] = dz;
  p.tmax = tmax;
  p.hit = hit;
  p.counters = counters;
  if (B <= 0) return (int)cudaGetLastError();
  const int grid = bpt::any_grid(B);
  if (grid < 0) return -grid;
  bpt::any_bvh<<<grid, bpt::WAVE_BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// hit_t / hit_tri: closest_bvh's hits of the state's rays.  V > 0 volumes
// over VT boundary triangles (vol, volm: pack_vol_tables) select
// pt_wave_bounce_vol, whose keys hold NU + V slots and which writes
// -2 - phase material into hit_tri where a lane scatters in a volume.
int bpt_pt_wave_bounce(int B, int N, int L, int bounce, const float* nodes,
                       const float* tris, const int* mat_id, const float* mat,
                       const float* lgt, const uint32_t* keys,
                       const float* state_in, const int* rid,
                       const float* hit_t, int* hit_tri,
                       float* state_out, unsigned long long* counters, int V,
                       int VT, const float* vol, const float* volm, void* stream) {
  if (V < 0 || V > bpt::MAX_VOLS || VT < 0 || VT > bpt::MAX_VOL_TRIS) {
    return (int)cudaErrorInvalidValue;
  }
  bpt::WaveParams p;
  p.B = B;
  p.L = L;
  p.bounce = bounce;
  p.g = bpt::Bvh{(const float4*)nodes, (const float4*)tris, N};
  p.mat_id = mat_id;
  p.mat = mat;
  p.lgt = lgt;
  p.keys = keys;
  p.in = state_in;
  p.rid = rid;
  p.hit_t = hit_t;
  p.hit_tri = hit_tri;
  p.out = state_out;
  p.counters = counters;
  p.V = V;
  p.VT = VT;
  p.vol = vol;
  p.volm = volm;
  if (B > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (V > 0) {
      bpt::pt_wave_bounce_vol<<<bpt::grid_of(B), bpt::WAVE_BLOCK, 0, st>>>(p);
    } else {
      bpt::pt_wave_bounce<<<bpt::grid_of(B), bpt::WAVE_BLOCK, 0, st>>>(p);
    }
  }
  return (int)cudaGetLastError();
}

// bvh64<false> (closest) and bvh64<true> (any): nodes [4N] double2, tris [5T]
// double2 (Bvh64); every lane array double but active, tri and hit.
static int launch_bvh64(bool any, bpt::Params64& p, int N, int bounds_ord, const double* nodes,
                        const double* tris, const double* ox, const double* oy,
                        const double* oz, const double* dx, const double* dy,
                        const double* dz, const double* tmin, const double* tmax,
                        unsigned long long* counters, void* stream) {
  p.g = bpt::Bvh64{(const double2*)nodes, (const double2*)tris, N};
  p.bounds_ord = bounds_ord;
  p.o[0] = ox;
  p.o[1] = oy;
  p.o[2] = oz;
  p.d[0] = dx;
  p.d[1] = dy;
  p.d[2] = dz;
  p.tmin = tmin;
  p.tmax = tmax;
  p.counters = counters;
  if (p.B <= 0) return (int)cudaGetLastError();
  const int grid = any ? bpt::bvh64_grid<true>(p.B) : bpt::bvh64_grid<false>(p.B);
  if (grid < 0) return -grid;
  const cudaStream_t st = (cudaStream_t)stream;
  if (any) {
    bpt::bvh64<true><<<grid, bpt::WAVE_BLOCK, 0, st>>>(p);
  } else {
    bpt::bvh64<false><<<grid, bpt::WAVE_BLOCK, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

int bpt_closest_bvh_f64(int B, int N, int bounds_ord, const double* nodes,
                        const double* tris, const double* ox,
                        const double* oy, const double* oz, const double* dx,
                        const double* dy, const double* dz, const double* tmin,
                        const double* tmax, const unsigned char* active, double* t,
                        int* tri, double* u, double* v, unsigned long long* counters,
                        void* stream) {
  bpt::Params64 p{};
  p.B = B;
  p.active = active;
  p.t = t;
  p.tri = tri;
  p.u = u;
  p.v = v;
  return launch_bvh64(false, p, N, bounds_ord, nodes, tris, ox, oy, oz, dx, dy, dz, tmin, tmax,
                      counters, stream);
}

int bpt_any_bvh_f64(int B, int N, int bounds_ord, const double* nodes,
                    const double* tris, const double* ox, const double* oy,
                    const double* oz, const double* dx, const double* dy,
                    const double* dz, const double* tmin, const double* tmax,
                    unsigned char* hit, unsigned long long* counters, void* stream) {
  bpt::Params64 p{};
  p.B = B;
  p.hit = hit;
  return launch_bvh64(true, p, N, bounds_ord, nodes, tris, ox, oy, oz, dx, dy, dz, tmin, tmax,
                      counters, stream);
}

// closest_bvh's and any_bvh's persistent grids (resident blocks), float32
// and (bpt_bvh_f64_blocks) float64, or a negative CUDA error code.
int bpt_wave_blocks() { return bpt::closest_grid(1 << 30); }
int bpt_any_blocks() { return bpt::any_grid(1 << 30); }
int bpt_bvh_f64_blocks(int any) {
  return any ? bpt::bvh64_grid<true>(1 << 30) : bpt::bvh64_grid<false>(1 << 30);
}

}  // extern "C"
