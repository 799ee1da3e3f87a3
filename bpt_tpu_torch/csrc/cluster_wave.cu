// Clustered closest and any hit over per-lane intervals for Hopper (sm_90a).
//
// clustered_closest replaces the Pallas kernel
// bpt_tpu/ops/pallas/cluster_wave.py::clustered_closest_pallas, and
// clustered_any replaces cluster_wave.py::clustered_any_pallas: the hits of
// bpt_tpu's dispatch on a large scene over any interval but the production
// one, and of every hit call under BPT_TPU_NO_FTB.  Each lane has its own
// [tmin, tmax]; tmax <= 0 marks a dead lane.  Out: t (inf on a miss), tri
// (-1 on a miss), u, v, or the any answer.
//
// The traversal (ops/clusters.py's tables): the superclusters in index
// order, each slab-tested with the bound min(t_best, tmax) (tmax for the
// any hit) and the entry clamped to T_MIN (clusters.py:378-395); on an
// entry, each member cluster slab-tested the same way; on an entry, the
// cluster's triangles in slot order by Moller-Trumbore, accepted on
// t >= T_MIN, tmin <= t <= tmax and t < t_best (cluster_wave.py:98).  The
// triangle id is the cluster's first triangle (its record's field 6) plus
// the slot.  The any hit ends the lane at its first hit.
//
// What bounds them on the H100: FP32 issue of the slab and triangle tests
// (25 and 52 operations), and the latency of a warp's steps where few warps
// have work; not device memory.  The combined table (88 KB for the
// 91k-triangle coffee stand-in) and the triangle blocks (3.3 MB) stay in
// the 50 MB L2 cache.  The lane-serial closest hit ran a cluster's slots
// once for every lane that entered it while the warp's other lanes waited
// (PERF.md §6, row 10: 4.0 of 32 lanes enter a cluster the warp tests at
// camera bounce 1 on coffee).
//
// Design.  Both hits run warp-wide on cluster_hit.cuh's persistent grid
// of compacted lanes: the warp steps through the superclusters, and an
// entered one's member clusters, in lockstep, each live lane (for the any
// hit, each lane still without a hit) slab-testing on its own bound; an
// entered cluster's triangles are read once, (v0, e1, e2) of slot s by
// thread s, and tested by Moller-Trumbore against each entering lane's ray
// in turn.  The TPU's layout does not carry over: its 128-lane tiles, the
// cluster block DMA'd to VMEM on a hit of any lane of the tile, and the
// lane roll that shows lane l the slots in the order (l + s) mod 32.  Two
// consequences, both in ops/kernels/cluster_wave.py:
// - A lane culls a box on its own slab test.  A NaN slab term (an origin
//   on a box plane with a zero direction component) leaves its axis
//   unconstrained (bvh_walk.cuh's slab_axis), so the lane tests every
//   cluster whose box holds its ray.  On the TPU the NaN fails the lane's
//   own test, and the lane rides along with any other lane of its tile
//   that enters.
// - Slots are taken in ascending order with a strict <: of equal t the
//   lowest triangle id wins.
// Built with -fmad=false (ops/kernels/build.py), each step rounds as the
// plain PyTorch version does, so kernel and plain version take the same
// branch at every step and count the same slab tests, boxes entered,
// triangle tests and accepted tests.  This file is cluster_hit.cuh's
// RolledMT provider.
#include "cluster_hit.cuh"

namespace bpt {

struct RolledMT {
  // The any hit, warp-wide (cluster_hit.cuh's cluster_any): the
  // superclusters and then an entered one's member clusters slab-tested by
  // every open lane that reaches them (a member only while the lane is
  // open, as _rolled drops closed lanes), each entered cluster's triangles
  // held one a thread and tested against each entering ray in turn; the
  // first valid slot ends the lane.
  __device__ static void any(const ClusterHitParams& p, ClusterLane& L, bool live,
                             float4 (*stage)[3]) {
    const int slot = threadIdx.x & 31;
    __syncwarp();
    if (live) {
      stage[slot][0] = make_float4(L.ox, L.oy, L.oz, L.dx);
      stage[slot][1] = make_float4(L.dy, L.dz, L.tmin, L.tmax);
    }
    __syncwarp();
    const float* spans = p.table + 6 * p.S;
    const float* recs = p.table + 8 * p.S;
    for (int s = 0; s < p.S; ++s) {
      const bool open = live && !L.done();
      if (!__ballot_sync(FULL_MASK, open)) break;
      const bool in_s = open && L.enters<true>(p.table + 6 * s);
      if (!__ballot_sync(FULL_MASK, in_s)) continue;
      const int first = (int)__ldg(spans + 2 * s);
      const int n_m = (int)__ldg(spans + 2 * s + 1);
      for (int k = first; k < first + n_m; ++k) {
        const bool open_k = in_s && !L.done();
        if (!__ballot_sync(FULL_MASK, open_k)) break;
        const float* rec = recs + 7 * k;
        const bool in_k = open_k && L.enters<true>(rec);
        unsigned mk = __ballot_sync(FULL_MASK, in_k);
        if (!mk) continue;
        const int base = (int)__ldg(rec + 6);
        const int n = (k + 1 < p.C ? (int)__ldg(rec + 13) : p.T) - base;
        const float* blk = p.blocks + (size_t)k * CLUSTER_TRIS * 9;
        float tv[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) tv[j] = __ldg(blk + 9 * slot + j);
        while (mk) {
          const int r = __ffs(mk) - 1;
          mk &= mk - 1;
          const float4 r0 = stage[r][0], r1 = stage[r][1];
          const float ox = r0.x, oy = r0.y, oz = r0.z, dx = r0.w, dy = r1.x, dz = r1.y;
          const float tmin = r1.z, tmax = r1.w;
          bool valid;
          const float t = moller_trumbore(ox, oy, oz, dx, dy, dz, tv, valid);
          warp_take_first(L, r, slot,
                          slot < n && valid && t >= T_MIN && t >= tmin && t <= tmax, n, base);
        }
      }
    }
  }

  // The closest hit, warp-wide (cluster_hit.cuh's cluster_closest): the
  // superclusters and then an entered one's member clusters slab-tested by
  // every lane that reaches them, each entered cluster's triangles held one
  // a thread and tested against each entering ray in turn.
  __device__ static void closest(const ClusterHitParams& p, ClusterLane& L, bool live,
                                 float4 (*stage)[3]) {
    const int slot = threadIdx.x & 31;
    __syncwarp();
    if (live) {
      stage[slot][0] = make_float4(L.ox, L.oy, L.oz, L.dx);
      stage[slot][1] = make_float4(L.dy, L.dz, L.tmin, L.tmax);
    }
    __syncwarp();
    const float* spans = p.table + 6 * p.S;
    const float* recs = p.table + 8 * p.S;
    for (int s = 0; s < p.S; ++s) {
      const bool in_s = live && L.enters<false>(p.table + 6 * s);
      if (!__ballot_sync(FULL_MASK, in_s)) continue;
      const int first = (int)__ldg(spans + 2 * s);
      const int n_m = (int)__ldg(spans + 2 * s + 1);
      for (int k = first; k < first + n_m; ++k) {
        const float* rec = recs + 7 * k;
        const bool in_k = in_s && L.enters<false>(rec);
        unsigned mk = __ballot_sync(FULL_MASK, in_k);
        if (!mk) continue;
        const int base = (int)__ldg(rec + 6);
        const int n = (k + 1 < p.C ? (int)__ldg(rec + 13) : p.T) - base;
        const float* blk = p.blocks + (size_t)k * CLUSTER_TRIS * 9;
        float tv[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) tv[j] = __ldg(blk + 9 * slot + j);
        while (mk) {
          const int r = __ffs(mk) - 1;
          mk &= mk - 1;
          const float4 r0 = stage[r][0], r1 = stage[r][1];
          const float ox = r0.x, oy = r0.y, oz = r0.z, dx = r0.w, dy = r1.x, dz = r1.y;
          const float tmin = r1.z, tmax = r1.w;
          const float t0 = lane_of(L.t, r);
          float u, v;
          bool valid;
          const float t = moller_trumbore_uv(ox, oy, oz, dx, dy, dz, tv, u, v, valid);
          const bool cand = slot < n && valid && t >= T_MIN && t >= tmin && t <= tmax && t < t0;
          warp_accept(L, r, slot, cand, t, u, v, base, t0);
          if (slot == r) L.c.tests += n;
        }
      }
    }
  }
};

}  // namespace bpt

extern "C" {

// The closest (any = 0: t, tri, u, v) or any hit (hit) on `stream`;
// returns cudaGetLastError() after the launch (0 = launched).  All
// pointers are device pointers.
int bpt_clustered_hit(int any, int B, int S, int C, int T, const float* table,
                      const float* blocks, const float* ox, const float* oy,
                      const float* oz, const float* dx, const float* dy,
                      const float* dz, const float* tmin, const float* tmax, float* t,
                      int* tri, float* u, float* v, unsigned char* hit,
                      unsigned long long* counters, int* sched, void* stream) {
  const float* rays[6] = {ox, oy, oz, dx, dy, dz};
  return bpt::launch_cluster_hit<bpt::RolledMT>(any, B, S, C, T, table, blocks, rays, tmin,
                                                tmax, t, tri, u, v, hit, counters, sched,
                                                stream);
}

// The closest and the any hit's persistent grids: resident blocks of 128
// threads, or a negative CUDA error code.
int bpt_clustered_blocks() { return bpt::cluster_blocks<bpt::RolledMT, false>(); }
int bpt_clustered_any_blocks() { return bpt::cluster_blocks<bpt::RolledMT, true>(); }

}  // extern "C"
