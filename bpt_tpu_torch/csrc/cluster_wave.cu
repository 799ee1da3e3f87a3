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
// (25 and 52 operations) and the divergence of a warp whose lanes enter
// different clusters; not device memory.  The combined table (88 KB for
// the 91k-triangle coffee stand-in) and the triangle blocks (3.3 MB) stay
// in the 50 MB L2 cache.
//
// Design: one thread per ray, reading the tables through the read-only
// path; the lanes of a warp that enter the same cluster read the same
// triangle in the same step.  The TPU's layout does not carry over: its
// 128-lane tiles, the cluster block DMA'd to VMEM on a hit of any lane of
// the tile, and the lane roll that shows lane l the slots in the order
// (l + s) mod 32.  Two consequences, both in ops/kernels/cluster_wave.py:
// - A lane culls a box on its own slab test.  A NaN slab term (an origin
//   on a box plane with a zero direction component) leaves its axis
//   unconstrained (bvh_walk.cuh's slab_axis), so the lane tests every
//   cluster whose box holds its ray.  On the TPU the NaN fails the lane's
//   own test, and the lane rides along with any other lane of its tile
//   that enters.
// - Slots run in ascending order with a strict <: of equal t the lowest
//   triangle id wins.
// Built with -fmad=false (ops/kernels/build.py), each step rounds as the
// plain PyTorch version does, so kernel and plain version take the same
// branch at every step and count the same slab tests, boxes entered,
// triangle tests and accepted tests.  The lane frame (loads, stores,
// counters, launch) is cluster_hit.cuh's; this file is its RolledMT
// provider.
#include "cluster_hit.cuh"

namespace bpt {

struct RolledMT {
  template <bool ANY>
  __device__ static void trace(const ClusterHitParams& p, ClusterLane& L) {
    const float* spans = p.table + 6 * p.S;
    const float* recs = p.table + 8 * p.S;
    for (int s = 0; s < p.S && !L.done<ANY>(); ++s) {
      if (!L.enters<ANY>(p.table + 6 * s)) continue;
      const int first = (int)__ldg(spans + 2 * s);
      const int n_m = (int)__ldg(spans + 2 * s + 1);
      for (int k = first; k < first + n_m && !L.done<ANY>(); ++k) {
        const float* rec = recs + 7 * k;
        if (!L.enters<ANY>(rec)) continue;
        const int base = (int)__ldg(rec + 6);
        const int n = (k + 1 < p.C ? (int)__ldg(rec + 13) : p.T) - base;
        const float* blk = p.blocks + (size_t)k * CLUSTER_TRIS * 9;
        for (int slot = 0; slot < n; ++slot) {
          L.c.tests += 1;
          float tv[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) tv[j] = __ldg(blk + 9 * slot + j);
          float u, v;
          bool valid;
          const float t =
              moller_trumbore_uv(L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, tv, u, v, valid);
          if (valid && t >= T_MIN && L.accepts<ANY>(t) && L.take<ANY>(base + slot, t, u, v)) {
            break;
          }
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
                      unsigned long long* counters, void* stream) {
  const float* rays[6] = {ox, oy, oz, dx, dy, dz};
  return bpt::launch_cluster_hit<bpt::RolledMT>(any, B, S, C, T, table, blocks, rays, tmin,
                                                tmax, t, tri, u, v, hit, counters, stream);
}

}  // extern "C"
