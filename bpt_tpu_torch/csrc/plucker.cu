// Plücker clustered closest and any hit for Hopper (sm_90a).
//
// plucker_closest replaces the Pallas kernel
// bpt_tpu/ops/pallas/plucker.py::plucker_closest_pallas, and plucker_any
// replaces plucker.py::plucker_any_pallas: the hits of bpt_tpu's dispatch on
// a large scene under BPT_TPU_WAVE_IMPL=plucker.  Each lane has its own
// [tmin, tmax]; tmax <= 0 marks a dead lane.  Out: t (inf on a miss), tri
// (-1 on a miss), u, v, or the any answer.
//
// The traversal (ops/plucker.py's tables): the fixed-stride chop clusters
// in index order, each slab-tested with the bound min(t_best, tmax) (tmax
// for the any hit) and the entry clamped to T_MIN; on an entry, the origin
// translated by the box centre (lo + hi) * 0.5 (plucker.py:207-209), the
// features f = [d, (o-c) x d, -(o-c), 1] (:111-121), and for each triangle
// in row order the four dot products w_ab, w_bc, w_ca and pn.  With
// denom = w_ab + w_bc + w_ca a triangle passes on |denom| >= MT_EPSILON and
// the signs of w_ca, w_ab, w_bc and w_ab + w_bc agreeing with denom's
// (:143-174); then t = pn / denom (as pn * (1 / denom)) in [tmin, tmax] (no
// T_MIN test) and t < t_best.  u = w_ca / denom, v = w_ab / denom; the
// triangle id is 32 c + row, and the lowest row wins a tie (:223-245).  The
// any hit ends the lane at its first hit (:250-294).
//
// What bounds them on the H100: FP32 issue.  A triangle test needs 62
// operations: each edge row [a x b, b - a, 0...] has 6 nonzero terms (11
// operations, three rows), the plane row [0..., n, n . v0] 3 and a
// constant (6), and the sign tests, reciprocal, t and the interval 23.
// The kernel sums all 10 terms of the four rows, 24 of its 40 coefficients
// zero by construction, and so issues 99.  Besides, 25 a slab test and 21
// for a cluster's features.  The chop clusters have no second level, so
// every live lane slab-tests every cluster (2,861 on the coffee stand-in).  The tables (aabb 69 KB,
// blocks 14.6 MB there) stay in the 50 MB L2 cache.
//
// Design: one thread per ray, reading a triangle's four rows of 10
// coefficients through the read-only path.  The Pallas kernel forms W = A f
// for a whole cluster and 128 rays as one f32 matrix product at the highest
// precision; here each dot product sums its 10 products in feature order,
// as the plain PyTorch version does, and with -fmad=false (ops/kernels/
// build.py) kernel and plain version agree to the bit and count the same
// slab tests, boxes entered, triangle tests and accepted tests.  No tensor
// cores: the products feed sign tests, which TF32 would flip on near-miss
// triangles.  Culling is per lane, with NaN slab terms unconstrained, as in
// cluster_wave.cu; so with tmin below T_MIN a lane finds hits in
// [tmin, T_MIN) only in clusters its own slab test enters, where the TPU
// tests a cluster for every lane of a tile that any lane enters.  The lane
// frame (loads, stores, counters, launch) is cluster_hit.cuh's; this file
// is its PluckerChop provider.
#include "cluster_hit.cuh"

namespace bpt {

constexpr int NFEAT = 10;

// sum_k a[k] * f[k] in feature order, each product and sum rounded.
__device__ __forceinline__ float dot10(const float* a, const float* f) {
  float w = __ldg(a) * f[0];
#pragma unroll
  for (int k = 1; k < NFEAT; ++k) w = w + __ldg(a + k) * f[k];
  return w;
}

// sign(x) agrees with sign(denom)
__device__ __forceinline__ bool agrees(float x, bool pos) {
  return (x >= 0.0f && pos) || (x <= 0.0f && !pos);
}

struct PluckerChop {
  template <bool ANY>
  __device__ static void trace(const ClusterHitParams& p, ClusterLane& L) {
    for (int k = 0; k < p.C && !L.done<ANY>(); ++k) {
      const float* box = p.table + 6 * k;
      if (!L.enters<ANY>(box)) continue;
      const float px = L.ox - (__ldg(box) + __ldg(box + 3)) * 0.5f;
      const float py = L.oy - (__ldg(box + 1) + __ldg(box + 4)) * 0.5f;
      const float pz = L.oz - (__ldg(box + 2) + __ldg(box + 5)) * 0.5f;
      const float f[NFEAT] = {L.dx, L.dy, L.dz, py * L.dz - pz * L.dy,
                              pz * L.dx - px * L.dz, px * L.dy - py * L.dx,
                              -px, -py, -pz, 1.0f};
      const int n = min(CLUSTER_TRIS, p.T - k * CLUSTER_TRIS);
      const float* blk = p.blocks + (size_t)k * 4 * CLUSTER_TRIS * NFEAT;
      for (int row = 0; row < n; ++row) {
        L.c.tests += 1;
        const float w_ab = dot10(blk + NFEAT * row, f);
        const float w_bc = dot10(blk + NFEAT * (CLUSTER_TRIS + row), f);
        const float w_ca = dot10(blk + NFEAT * (2 * CLUSTER_TRIS + row), f);
        const float pn = dot10(blk + NFEAT * (3 * CLUSTER_TRIS + row), f);
        const float denom = w_ab + w_bc + w_ca;
        const bool pos = denom > 0.0f;
        const float rd = 1.0f / denom;
        const float t = pn * rd;
        if (fabsf(denom) >= MT_EPSILON && agrees(w_ca, pos) && agrees(w_ab, pos) &&
            agrees(w_bc, pos) && agrees(w_ab + w_bc, pos) && L.accepts<ANY>(t) &&
            L.take<ANY>(k * CLUSTER_TRIS + row, t, w_ca * rd, w_ab * rd)) {
          break;
        }
      }
    }
  }
};

}  // namespace bpt

extern "C" {

// The closest (any = 0: t, tri, u, v) or any hit (hit) on `stream`; S is
// unused (the chop clusters have one level).  Returns cudaGetLastError()
// after the launch (0 = launched).  All pointers are device pointers.
int bpt_plucker_hit(int any, int B, int S, int C, int T, const float* aabb,
                    const float* blocks, const float* ox, const float* oy,
                    const float* oz, const float* dx, const float* dy,
                    const float* dz, const float* tmin, const float* tmax, float* t,
                    int* tri, float* u, float* v, unsigned char* hit,
                    unsigned long long* counters, void* stream) {
  const float* rays[6] = {ox, oy, oz, dx, dy, dz};
  return bpt::launch_cluster_hit<bpt::PluckerChop>(any, B, S, C, T, aabb, blocks, rays, tmin,
                                                   tmax, t, tri, u, v, hit, counters, stream);
}

}  // extern "C"
