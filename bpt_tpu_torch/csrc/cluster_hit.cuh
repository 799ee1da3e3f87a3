// The lane frame of the clustered hit kernels over per-lane intervals, one
// thread per ray, shared by two traversals (providers):
// - cluster_wave.cu's RolledMT: superclusters, then their member clusters,
//   then each cluster's triangles by Moller-Trumbore (kernels 10-11);
// - plucker.cu's PluckerChop: the fixed-stride chop clusters, then each
//   cluster's triangles by Plucker products (kernels 12-13).
// The frame loads a lane's ray and [tmin, tmax] (tmax <= 0 marks a dead
// lane: it misses and tests nothing), runs the provider, writes t (inf on
// a miss), tri (-1 on a miss), u, v, or the any answer, and sums the
// lane's counters into 64-bit counters (warp sums, one atomic per warp).
//
// A provider calls ClusterLane::enters for each box it slab-tests and
// ClusterLane::accepts / take for each triangle, so both count slab
// tests, boxes entered, triangle tests (the provider's own += 1) and
// accepted tests alike, and both accept by one rule: t in [tmin, tmax]
// and, for the closest hit, t < t_best, the triangles of a cluster in
// ascending order, so of equal t the lowest id wins.  The any hit ends
// the lane at its first accepted test.
#pragma once

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace bpt {

constexpr int CLUSTER_BLOCK = 128;
constexpr int CLUSTER_TRIS = 32;

struct ClusterHitParams {
  int B, S, C, T;       // lanes, superclusters (rolled only), clusters, triangles
  const float* table;   // rolled: [S*6 super boxes | S*2 spans | C*7 cluster
                        // records]; Plucker: [C*6] chop boxes (lo3, hi3)
  const float* blocks;  // rolled: [C, 32, 9] v0, e1, e2; Plucker: [C, 128, 10]
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

  template <bool ANY>
  __device__ __forceinline__ bool done() const {
    return ANY && tri >= 0;
  }
  // One slab test of box (lo3, hi3), bounded by min(t_best, tmax) (tmax
  // for the any hit), the entry clamped to T_MIN.
  template <bool ANY>
  __device__ __forceinline__ bool enters(const float* box) {
    c.nodes += 1;
    const bool in = box_entered(box, ox, oy, oz, ix, iy, iz, ANY ? tmax : fminf(t, tmax));
    c.boxes += in;
    return in;
  }
  template <bool ANY>
  __device__ __forceinline__ bool accepts(float t_hit) const {
    return t_hit >= tmin && t_hit <= tmax && (ANY || t_hit < t);
  }
  // Takes an accepted test; true when the lane ends (the any hit).
  template <bool ANY>
  __device__ __forceinline__ bool take(int id, float t_hit, float u_hit, float v_hit) {
    c.hits += 1;
    tri = id;
    if (ANY) return true;
    t = t_hit;
    u = u_hit;
    v = v_hit;
    return false;
  }
};

template <class Provider, bool ANY>
__global__ void __launch_bounds__(CLUSTER_BLOCK) cluster_hit(const ClusterHitParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  ClusterLane L;
  L.t = inf_f();
  L.u = 0.0f;
  L.v = 0.0f;
  L.tri = -1;
  if (lane < p.B) {
    L.tmax = p.tmax[lane];
    if (L.tmax > 0.0f) {
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
      Provider::template trace<ANY>(p, L);
    }
    if constexpr (ANY) {
      p.hit[lane] = L.tri >= 0;
    } else {
      p.t[lane] = L.t;
      p.tri[lane] = L.tri;
      p.u[lane] = L.u;
      p.v[lane] = L.v;
    }
  }
  warp_add(L.c.nodes, &p.counters[0]);
  warp_add(L.c.boxes, &p.counters[1]);
  warp_add(L.c.tests, &p.counters[2]);
  warp_add(L.c.hits, &p.counters[3]);
}

// The C entry points' launch: the closest (any = 0) or any hit of
// Provider on `stream`; returns cudaGetLastError() after the launch (0 =
// launched).  The closest hit writes t, tri, u, v, the any hit `hit`.
template <class Provider>
int launch_cluster_hit(int any, int B, int S, int C, int T, const float* table,
                       const float* blocks, const float* const* rays,
                       const float* tmin, const float* tmax, float* t, int* tri,
                       float* u, float* v, unsigned char* hit,
                       unsigned long long* counters, void* stream) {
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
    const int grid = (B + CLUSTER_BLOCK - 1) / CLUSTER_BLOCK;
    if (any) {
      cluster_hit<Provider, true><<<grid, CLUSTER_BLOCK, 0, (cudaStream_t)stream>>>(p);
    } else {
      cluster_hit<Provider, false><<<grid, CLUSTER_BLOCK, 0, (cudaStream_t)stream>>>(p);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace bpt
