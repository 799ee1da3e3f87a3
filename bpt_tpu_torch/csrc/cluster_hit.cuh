// The frame of the clustered hit kernels over per-lane intervals, shared by
// two traversals (providers):
// - cluster_wave.cu's RolledMT: superclusters, then their member clusters,
//   then each cluster's triangles by Moller-Trumbore (kernels 10-11);
// - plucker.cu's PluckerChop: the fixed-stride chop clusters, then each
//   cluster's triangles by Plucker products (kernels 12-13).
// A lane has a ray and [tmin, tmax] (tmax <= 0 marks a dead lane: it
// misses and tests nothing).  Out: t (inf on a miss), tri (-1 on a miss),
// u, v, or the any answer, and the lanes' counters (slab tests, boxes
// entered, triangle tests, accepted tests) summed into 64-bit counters,
// one atomic a warp.  Both hits slab-test a box with ClusterLane::enters
// (bound min(t_best, tmax), tmax for the any hit; entry clamped to T_MIN)
// and accept a triangle by one rule: t in [tmin, tmax] and, for the
// closest hit, t < t_best (inf at first), a cluster's triangles in
// ascending order, so of equal t the lowest id wins.  The any hit ends a
// lane at its first accepted test; its Plucker test takes t < inf too, as
// the closest hit's t < t_best does.
//
// Both hits (PERF.md §6, rows 10-13) run warp-wide on a persistent grid
// of compacted lanes: cluster_live<Provider, ANY> compacts the live
// lanes, then cluster_closest<Provider> or cluster_any<Provider>, the two
// instances of one frame (cluster_run<Provider, ANY>), runs them.
// - What bounded the lane-serial closest hit on the H100: a warp stepped
//   through an entered cluster's 32 slots for each lane that entered it,
//   its other lanes waiting, and reloaded each triangle with scalar loads.
//   On the coffee stand-in 4.0 of a warp's 32 lanes enter a cluster the
//   warp tests at camera bounce 1, 7.3 at the render's last closest launch,
//   so the warp took 4-8x the steps its tests need.  Besides, most of a
//   render's launches hold under 250,000 live lanes of 1,048,576 (sorted
//   first), and one thread a lane gave them too few warps to fill the card.
// - Design: the box loops are warp-uniform: at each step every live lane
//   slab-tests the same box on its own bound, and __ballot_sync marks the
//   lanes that enter.  An entered cluster's slots are read once, one a
//   thread, and tested against each entering lane's ray in turn (the ray
//   staged in shared memory by its lane, three 16-byte loads), with the
//   same expressions as the lane-serial loop, so to the same bits;
//   warp_accept then takes the candidates as the slot-order loop with its
//   strict < does.  A warp takes units of k compacted lanes from a
//   counter, k a power of two chosen from the live lanes and the grid's
//   warps, so that a launch with few live lanes still spreads them over
//   the card.  A lane's answer and counters do not depend on its warp.
// - What bounded a thread-a-lane any hit (rows 11 and 13) over ceil(B /
//   128) blocks: a shadow wave of 10,485,760 lanes holds 4,302-721,716 live
//   ones, sorted first, so a sparse wave ran on a few SMs, each lane
//   walking every box and an entered cluster's slots alone (an unoccluded
//   ray, the common case, to the end).  So the any hit takes the closest
//   hit's design: its box loops are warp-uniform over the lanes still open
//   (live, no hit yet) and end as soon as none is; an entered cluster's
//   slots are tested one a thread against each entering ray in turn, and
//   the lowest set bit of the ballot of valid slots is the lane's first
//   accepted test (warp_take_first), as the lane-serial loop takes it.  A
//   lane with a hit tests no further box, so its counters stop where the
//   lane-serial loop's do, and its thread still takes part in the slot
//   tests.
#pragma once

#include <cuda_runtime.h>

#include "bvh_walk.cuh"
#include "walk_sched.cuh"

namespace bpt {

constexpr int CLUSTER_BLOCK = 128;
constexpr int CLUSTER_TRIS = 32;

struct ClusterHitParams {
  int B, S, C, T;       // lanes, superclusters (rolled) or chop groups
                        // (Plucker), clusters, triangles
  const float* table;   // rolled: [S*6 super boxes | S*2 spans | C*7 cluster
                        // records]; Plucker: [C*6] chop boxes (lo3, hi3), then
                        // the [S*6] group boxes
  const float* blocks;  // rolled: [C, 32, 9] v0, e1, e2; Plucker: [C, 22, 32]
  const float* o[3];
  const float* d[3];
  const float* tmin;
  const float* tmax;    // <= 0 marks a dead lane
  float* t;             // closest: [B]
  int* tri;             // closest: [B]
  float* u;             // closest: [B]
  float* v;             // closest: [B]
  unsigned char* hit;   // any: [B] bool
  unsigned long long* counters;  // [4] slab tests, boxes entered, tri tests, accepted tests
};

// A live lane's ray, interval, best hit so far and counters.
struct ClusterLane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, tmax;
  float t, u, v;
  int tri;
  TraceCounts c;

  // The any hit's lane has taken a hit and ends.
  __device__ __forceinline__ bool done() const { return tri >= 0; }
  // One slab test of box (lo3, hi3), bounded by min(t_best, tmax) (tmax
  // for the any hit), the entry clamped to T_MIN.
  template <bool ANY>
  __device__ __forceinline__ bool enters(const float* box) {
    c.nodes += 1;
    const bool in = box_entered(box, ox, oy, oz, ix, iy, iz, ANY ? tmax : fminf(t, tmax));
    c.boxes += in;
    return in;
  }
};

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float lane_of(float x, int r) {
  return __shfl_sync(FULL_MASK, x, r);
}

// One cluster's candidates for the ray of lane r, one slot a thread (slot =
// the thread's lane id): `cand` is the slot's test passed with t below the
// ray's t_best t0.  Scans the candidates in slot order with a strict <, as
// the lane-serial loop takes them, and hands lane r the last one taken (the
// first of the smallest t), its (u, v) and triangle base + slot, and the
// count taken as its accepted tests.  Every thread runs the same scan.
__device__ __forceinline__ void warp_accept(ClusterLane& L, int r, int slot, bool cand,
                                          float t, float u, float v, int base, float t0) {
  const unsigned cm = __ballot_sync(FULL_MASK, cand);
  if (!cm) return;
  float run = t0;
  int win = 0;
  unsigned taken = 0;
  for (unsigned m = cm; m; m &= m - 1) {
    const int s = __ffs(m) - 1;
    const float ts = lane_of(t, s);
    if (ts < run) {
      run = ts;
      win = s;
      taken += 1;
    }
  }
  const float ub = lane_of(u, win);
  const float vb = lane_of(v, win);
  if (slot == r) {
    L.t = run;
    L.u = ub;
    L.v = vb;
    L.tri = base + win;
    L.c.hits += taken;
  }
}

// The any hit's take of one cluster of n slots for the ray of lane r, one
// slot a thread: `valid` is the slot's test accepted.  The first valid slot,
// the lowest set bit of their ballot, ends lane r with triangle base + that
// slot: it counts the tests up to it and one accepted test, or n tests
// without a valid slot (Lanes.accept's any branch).
__device__ __forceinline__ void warp_take_first(ClusterLane& L, int r, int slot, bool valid,
                                                int n, int base) {
  const unsigned vm = __ballot_sync(FULL_MASK, valid);
  if (slot != r) return;
  if (!vm) {
    L.c.tests += n;
    return;
  }
  const int first = __ffs(vm) - 1;
  L.c.tests += first + 1;
  L.c.hits += 1;
  L.tri = base + first;
}

// The hit's lanes, compacted (cluster_live<Provider, ANY>, launched before
// the hit on the same stream; a template, so that each provider's source
// has its own): each warp of 32 lanes with a live one takes an aligned
// chunk of 32 slots of sched[2..] (its lanes, -1 for a dead one) with one
// atomic on sched[0], and writes its dead lanes' misses (the any hit's
// false).  sched[1] is the hit's work counter; the launch zeroes both.
// Both are int32, as the slots are: a launch's slots and units stay under
// 2^31.
template <class Provider, bool ANY>
__global__ void __launch_bounds__(CLUSTER_BLOCK) cluster_live(const ClusterHitParams p,
                                                              int* sched) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = lane < p.B;
  const bool live = in && p.tmax[lane] > 0.0f;
  if (in && !live) {
    if constexpr (ANY) {
      p.hit[lane] = 0;
    } else {
      p.t[lane] = inf_f();
      p.tri[lane] = -1;
      p.u[lane] = 0.0f;
      p.v[lane] = 0.0f;
    }
  }
  const unsigned m = __ballot_sync(FULL_MASK, live);
  if (!m) return;
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(sched, 32);
  base = __shfl_sync(FULL_MASK, base, 0);
  sched[2 + base + (threadIdx.x & 31)] = live ? lane : -1;
}

// The closest (ANY = false) or any hit, warp-wide, on a persistent grid
// (the header's design): a warp takes units of k compacted slots, k the
// least power of two that spreads the slots over the grid's warps (at most
// 32), and runs the provider's closest or any over the unit's lanes
// (threads 0..k-1; the others dead), writing each live lane's hit or
// answer.  A live lane stages its ray in `stage`, a warp's 32 rows of three
// float4, for the warp's threads to read.  The counters are each lane's,
// summed once a warp at the end.  The kernels cluster_closest and
// cluster_any are its two instances.
template <class Provider, bool ANY>
__device__ __forceinline__ void cluster_run(const ClusterHitParams& p, int* sched) {
  const int slots = sched[0];
  const int warps = gridDim.x * (CLUSTER_BLOCK / 32);
  int k = 32;
  while (k > 1 && (k / 2) * warps >= slots) k /= 2;
  const int units = (slots + k - 1) / k;
  const int l = threadIdx.x & 31;
  __shared__ float4 stage[CLUSTER_BLOCK / 32][32][3];
  float4(*mine)[3] = stage[threadIdx.x >> 5];
  TraceCounts sum;
  for (;;) {
    int unit = 0;
    if (l == 0) unit = atomicAdd(sched + 1, 1);
    unit = __shfl_sync(FULL_MASK, unit, 0);
    if (unit >= units) break;
    const int j = unit * k + l;
    const int lane = l < k && j < slots ? sched[2 + j] : -1;
    const bool live = lane >= 0;
    ClusterLane L;
    if constexpr (!ANY) {
      L.t = inf_f();
      L.u = 0.0f;
      L.v = 0.0f;
    }
    L.tri = -1;
    if (live) {
      L.tmax = p.tmax[lane];
      L.tmin = p.tmin[lane];
      L.ox = p.o[0][lane];
      L.oy = p.o[1][lane];
      L.oz = p.o[2][lane];
      L.dx = p.d[0][lane];
      L.dy = p.d[1][lane];
      L.dz = p.d[2][lane];
      L.ix = 1.0f / L.dx;
      L.iy = 1.0f / L.dy;
      L.iz = 1.0f / L.dz;
    }
    if (__ballot_sync(FULL_MASK, live)) {
      if constexpr (ANY) {
        Provider::any(p, L, live, mine);
      } else {
        Provider::closest(p, L, live, mine);
      }
    }
    if (live) {
      if constexpr (ANY) {
        p.hit[lane] = L.tri >= 0;
      } else {
        p.t[lane] = L.t;
        p.tri[lane] = L.tri;
        p.u[lane] = L.u;
        p.v[lane] = L.v;
      }
    }
    sum.nodes += L.c.nodes;
    sum.boxes += L.c.boxes;
    sum.tests += L.c.tests;
    sum.hits += L.c.hits;
  }
  warp_add(sum.nodes, &p.counters[0]);
  warp_add(sum.boxes, &p.counters[1]);
  warp_add(sum.tests, &p.counters[2]);
  warp_add(sum.hits, &p.counters[3]);
}

template <class Provider>
__global__ void __launch_bounds__(CLUSTER_BLOCK) cluster_closest(const ClusterHitParams p,
                                                                 int* sched) {
  cluster_run<Provider, false>(p, sched);
}

template <class Provider>
__global__ void __launch_bounds__(CLUSTER_BLOCK) cluster_any(const ClusterHitParams p,
                                                             int* sched) {
  cluster_run<Provider, true>(p, sched);
}

// The closest or any hit's persistent grid (resident blocks of
// CLUSTER_BLOCK), or a negative CUDA error code.
template <class Provider, bool ANY>
int cluster_blocks() {
  static int cache[64] = {0};
  if constexpr (ANY) {
    return resident_blocks(cluster_any<Provider>, CLUSTER_BLOCK, cache, 64);
  } else {
    return resident_blocks(cluster_closest<Provider>, CLUSTER_BLOCK, cache, 64);
  }
}

// The C entry points' launch: the closest (any = 0) or any hit of
// Provider on `stream`; returns cudaGetLastError() after the launches (0 =
// launched).  The closest hit writes t, tri, u, v, the any hit `hit`; both
// take `sched`, int32 scratch of 2 + 32 ceil(B / 32) (cluster_live).
template <class Provider>
int launch_cluster_hit(int any, int B, int S, int C, int T, const float* table,
                       const float* blocks, const float* const* rays,
                       const float* tmin, const float* tmax, float* t, int* tri,
                       float* u, float* v, unsigned char* hit,
                       unsigned long long* counters, int* sched, void* stream) {
  ClusterHitParams p{};
  p.B = B;
  p.S = S;
  p.C = C;
  p.T = T;
  p.table = table;
  p.blocks = blocks;
  for (int k = 0; k < 3; ++k) {
    p.o[k] = rays[k];
    p.d[k] = rays[3 + k];
  }
  p.tmin = tmin;
  p.tmax = tmax;
  p.t = t;
  p.tri = tri;
  p.u = u;
  p.v = v;
  p.hit = hit;
  p.counters = counters;
  if (B > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int grid = (B + CLUSTER_BLOCK - 1) / CLUSTER_BLOCK;
    const int blocks = any ? cluster_blocks<Provider, true>() : cluster_blocks<Provider, false>();
    if (blocks < 0) return -blocks;
    cudaError_t err = cudaMemsetAsync(sched, 0, 2 * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    if (any) {
      cluster_live<Provider, true><<<grid, CLUSTER_BLOCK, 0, s>>>(p, sched);
      cluster_any<Provider><<<blocks, CLUSTER_BLOCK, 0, s>>>(p, sched);
    } else {
      cluster_live<Provider, false><<<grid, CLUSTER_BLOCK, 0, s>>>(p, sched);
      cluster_closest<Provider><<<blocks, CLUSTER_BLOCK, 0, s>>>(p, sched);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace bpt
