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
// T_MIN test) and t < t_best (inf at first; so the any hit takes t < inf
// too).  u = w_ca / denom, v = w_ab / denom; the triangle id is 32 c +
// row, and the lowest row wins a tie (:223-245).  The any hit ends the
// lane at its first hit (:250-294).
//
// What bounds them on the H100: FP32 issue, and the latency of a warp's
// steps where few warps have work.  A triangle test needs 62 operations:
// each edge row [a x b, b - a, 0...] has 6 nonzero terms (11 operations,
// three rows), the plane row [0..., n, n . v0] 3 and a constant (6), and
// the sign tests, reciprocal, t and the interval 23; besides, 25 a slab
// test and 21 for a cluster's features.  The chop clusters have no second
// level in bpt_tpu, so a lane slab-tests every cluster (2,861 on the
// coffee stand-in: 58.6% of the FP32 operations at camera bounce 1; under
// the groups below a lane needs a tenth of those tests there).  The
// tables (the chop and group boxes, the 22-coefficient table: 8.1 MB
// there) stay in the 50 MB L2 cache.
//
// Design.  Both hits run warp-wide on cluster_hit.cuh's persistent grid of
// compacted lanes:
// - groups of 16 chop clusters, whose boxes hold their members' boxes on
//   any bound, so that a group no lane of the warp enters is skipped whole;
//   a lane still counts the slab tests the lane-serial loop runs (C, or
//   k + 1 for the any hit's hit in chop cluster k);
// - an entered cluster's 22 nonzero coefficients a triangle ([C, 22, 32],
//   ops/plucker.py), read once, slot s by thread s with coalesced loads,
//   and tested against each entering lane's features in turn.  The zero
//   products the lane-serial sums add change a partial sum only where it is
//   a zero or a NaN, and the kernel adds the same zero or NaN once a row
//   (PluckerChop::closest), so each sum keeps its bits.
// The Pallas kernel forms W = A f for a whole cluster and 128 rays as one
// f32 matrix product at the highest precision; here each dot product sums
// its products in feature order, as the plain PyTorch version does, and
// with -fmad=false (ops/kernels/build.py) kernel and plain version agree
// to the bit and count the same slab tests, boxes entered, triangle tests
// and accepted tests.  No tensor cores: the products feed sign tests,
// which TF32 would flip on near-miss triangles.  Culling is per lane, with
// NaN slab terms unconstrained, as in cluster_wave.cu; so with tmin below
// T_MIN a lane finds hits in [tmin, T_MIN) only in clusters its own slab
// test enters, where the TPU tests a cluster for every lane of a tile that
// any lane enters.  This file is cluster_hit.cuh's PluckerChop provider.
#include "cluster_hit.cuh"

namespace bpt {

constexpr int NFEAT = 10;
// nonzero coefficients of a triangle (the [C, 22, 32] table) and chop
// clusters a group
constexpr int NCOEF = 22;
constexpr int GROUP = 16;

// sign(x) agrees with sign(denom)
__device__ __forceinline__ bool agrees(float x, bool pos) {
  return (x >= 0.0f && pos) || (x <= 0.0f && !pos);
}

struct PluckerChop {
  // The any hit, warp-wide (cluster_hit.cuh's cluster_any), on the closest
  // hit's groups and [C, 22, 32] coefficients: a group no open lane enters
  // on its bound tmax is skipped whole, an entered chop cluster's slots are
  // tested one a thread against each entering lane's features in turn, with
  // the closest hit's expressions (so to the bits of the [C, 128, 10] rows'
  // sums), and the first valid slot ends the lane; besides, t < inf (the
  // rule of the plain version and of the Pallas kernel's t < t_best = inf:
  // a t that overflows is no hit).  A lane counts the slab tests the
  // lane-serial loop ran, k + 1 for a hit in chop cluster k, else C.
  __device__ static void any(const ClusterHitParams& p, ClusterLane& L, bool live,
                             float4 (*stage)[3]) {
    const int slot = threadIdx.x & 31;
    const float* groups = p.table + 6 * p.C;
    for (int g = 0; g < p.S; ++g) {
      const bool open = live && !L.done();
      if (!__ballot_sync(FULL_MASK, open)) break;
      const bool in_g =
          open && box_entered(groups + 6 * g, L.ox, L.oy, L.oz, L.ix, L.iy, L.iz, L.tmax);
      if (!__ballot_sync(FULL_MASK, in_g)) continue;
      const int k_end = min(p.C, (g + 1) * GROUP);
      for (int k = g * GROUP; k < k_end; ++k) {
        const bool open_k = in_g && !L.done();
        if (!__ballot_sync(FULL_MASK, open_k)) break;
        const float* box = p.table + 6 * k;
        const bool in_k = open_k && L.enters<true>(box);
        unsigned mk = __ballot_sync(FULL_MASK, in_k);
        if (!mk) continue;
        const float px = L.ox - (__ldg(box) + __ldg(box + 3)) * 0.5f;
        const float py = L.oy - (__ldg(box + 1) + __ldg(box + 4)) * 0.5f;
        const float pz = L.oz - (__ldg(box + 2) + __ldg(box + 5)) * 0.5f;
        const float m0 = py * L.dz - pz * L.dy;
        const float m1 = pz * L.dx - px * L.dz;
        const float m2 = px * L.dy - py * L.dx;
        const int n = min(CLUSTER_TRIS, p.T - k * CLUSTER_TRIS);
        __syncwarp();
        if (in_k) {
          stage[slot][0] = make_float4(L.dx, L.dy, L.dz, m0);
          stage[slot][1] = make_float4(m1, m2, -px, -py);
          stage[slot][2] = make_float4(-pz, L.tmin, L.tmax, 0.0f);
        }
        __syncwarp();
        const float* blk = p.blocks + (size_t)k * NCOEF * CLUSTER_TRIS + slot;
        float a[NCOEF];
#pragma unroll
        for (int j = 0; j < NCOEF; ++j) a[j] = __ldg(blk + j * CLUSTER_TRIS);
        while (mk) {
          const int r = __ffs(mk) - 1;
          mk &= mk - 1;
          const float4 a0 = stage[r][0], a1 = stage[r][1], a2 = stage[r][2];
          const float f[NFEAT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, 1.0f};
          const float tmin = a2.y, tmax = a2.z;
          const float ze = ((0.0f * f[6] + 0.0f * f[7]) + 0.0f * f[8]) + 0.0f;
          const float zp = ((((0.0f * f[0] + 0.0f * f[1]) + 0.0f * f[2]) + 0.0f * f[3]) +
                            0.0f * f[4]) + 0.0f * f[5];
          float w[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float* c = a + 6 * e;
            w[e] = (((((c[0] * f[0] + c[1] * f[1]) + c[2] * f[2]) + c[3] * f[3]) +
                     c[4] * f[4]) + c[5] * f[5]) + ze;
          }
          const float pn =
              (((zp + a[18] * f[6]) + a[19] * f[7]) + a[20] * f[8]) + a[21] * f[9];
          const float w_ab = w[0], w_bc = w[1], w_ca = w[2];
          const float denom = w_ab + w_bc + w_ca;
          const bool pos = denom > 0.0f;
          const float t = pn * (1.0f / denom);
          const bool valid = slot < n && fabsf(denom) >= MT_EPSILON && agrees(w_ca, pos) &&
                             agrees(w_ab, pos) && agrees(w_bc, pos) &&
                             agrees(w_ab + w_bc, pos) && t >= tmin && t <= tmax &&
                             t < inf_f();
          warp_take_first(L, r, slot, valid, n, k * CLUSTER_TRIS);
        }
      }
    }
    if (live) L.c.nodes = L.done() ? L.tri / CLUSTER_TRIS + 1 : p.C;
  }

  // The closest hit, warp-wide (cluster_hit.cuh's cluster_closest).  S
  // groups of 16 chop clusters come first (their boxes after the C chop
  // boxes in the table): a lane misses every box of a group whose box it
  // misses, the group's box holding each member's, so a group no lane
  // enters is skipped whole.  Each live lane still counts C slab tests,
  // as the lane-serial loop does.  In an entered chop cluster thread s
  // holds slot s's 22 nonzero coefficients ([C, 22, 32]: the three edge
  // rows' first 6, then the plane row's last 4) and tests each entering
  // lane's features in turn.  The zero products the lane-serial sums add
  // change a partial sum only where it is a zero or a NaN: the edge rows
  // add ze = (0 f6 + 0 f7) + 0 f8 + 0, which is +0 or NaN, and the plane row
  // starts from zp, the sum of 0 f0 .. 0 f5, so each sum keeps its bits.
  __device__ static void closest(const ClusterHitParams& p, ClusterLane& L, bool live,
                                 float4 (*stage)[3]) {
    const int slot = threadIdx.x & 31;
    const float* groups = p.table + 6 * p.C;
    for (int g = 0; g < p.S; ++g) {
      const bool in_g = live && box_entered(groups + 6 * g, L.ox, L.oy, L.oz, L.ix, L.iy,
                                            L.iz, fminf(L.t, L.tmax));
      if (!__ballot_sync(FULL_MASK, in_g)) continue;
      const int k_end = min(p.C, (g + 1) * GROUP);
      for (int k = g * GROUP; k < k_end; ++k) {
        const bool in_k = in_g && L.enters<false>(p.table + 6 * k);
        unsigned mk = __ballot_sync(FULL_MASK, in_k);
        if (!mk) continue;
        const float* box = p.table + 6 * k;
        const float px = L.ox - (__ldg(box) + __ldg(box + 3)) * 0.5f;
        const float py = L.oy - (__ldg(box + 1) + __ldg(box + 4)) * 0.5f;
        const float pz = L.oz - (__ldg(box + 2) + __ldg(box + 5)) * 0.5f;
        const float m0 = py * L.dz - pz * L.dy;
        const float m1 = pz * L.dx - px * L.dz;
        const float m2 = px * L.dy - py * L.dx;
        const int n = min(CLUSTER_TRIS, p.T - k * CLUSTER_TRIS);
        __syncwarp();
        if (in_k) {
          stage[slot][0] = make_float4(L.dx, L.dy, L.dz, m0);
          stage[slot][1] = make_float4(m1, m2, -px, -py);
          stage[slot][2] = make_float4(-pz, L.tmin, L.tmax, L.t);
        }
        __syncwarp();
        const float* blk = p.blocks + (size_t)k * NCOEF * CLUSTER_TRIS + slot;
        float a[NCOEF];
#pragma unroll
        for (int j = 0; j < NCOEF; ++j) a[j] = __ldg(blk + j * CLUSTER_TRIS);
        while (mk) {
          const int r = __ffs(mk) - 1;
          mk &= mk - 1;
          const float4 a0 = stage[r][0], a1 = stage[r][1], a2 = stage[r][2];
          const float f[NFEAT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, 1.0f};
          const float tmin = a2.y, tmax = a2.z, t0 = a2.w;
          const float ze = ((0.0f * f[6] + 0.0f * f[7]) + 0.0f * f[8]) + 0.0f;
          const float zp = ((((0.0f * f[0] + 0.0f * f[1]) + 0.0f * f[2]) + 0.0f * f[3]) +
                            0.0f * f[4]) + 0.0f * f[5];
          float w[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float* c = a + 6 * e;
            w[e] = (((((c[0] * f[0] + c[1] * f[1]) + c[2] * f[2]) + c[3] * f[3]) +
                     c[4] * f[4]) + c[5] * f[5]) + ze;
          }
          const float pn =
              (((zp + a[18] * f[6]) + a[19] * f[7]) + a[20] * f[8]) + a[21] * f[9];
          const float w_ab = w[0], w_bc = w[1], w_ca = w[2];
          const float denom = w_ab + w_bc + w_ca;
          const bool pos = denom > 0.0f;
          const float rd = 1.0f / denom;
          const float t = pn * rd;
          const bool cand = slot < n && fabsf(denom) >= MT_EPSILON && agrees(w_ca, pos) &&
                            agrees(w_ab, pos) && agrees(w_bc, pos) &&
                            agrees(w_ab + w_bc, pos) && t >= tmin && t <= tmax && t < t0;
          warp_accept(L, r, slot, cand, t, w_ca * rd, w_ab * rd, k * CLUSTER_TRIS, t0);
          if (slot == r) L.c.tests += n;
        }
      }
    }
    if (live) L.c.nodes = p.C;
  }
};

}  // namespace bpt

extern "C" {

// The closest (any = 0: t, tri, u, v) or any hit (hit) on `stream`.  Both
// read S groups of chop clusters (their boxes after the C chop boxes in
// `aabb`) and the [C, 22, 32] coefficients as `blocks`.  Returns
// cudaGetLastError() after the launches (0 = launched).  All pointers are
// device pointers.
int bpt_plucker_hit(int any, int B, int S, int C, int T, const float* aabb,
                    const float* blocks, const float* ox, const float* oy,
                    const float* oz, const float* dx, const float* dy,
                    const float* dz, const float* tmin, const float* tmax, float* t,
                    int* tri, float* u, float* v, unsigned char* hit,
                    unsigned long long* counters, int* sched, void* stream) {
  const float* rays[6] = {ox, oy, oz, dx, dy, dz};
  return bpt::launch_cluster_hit<bpt::PluckerChop>(any, B, S, C, T, aabb, blocks, rays, tmin,
                                                   tmax, t, tri, u, v, hit, counters, sched,
                                                   stream);
}

// The closest and the any hit's persistent grids: resident blocks of 128
// threads, or a negative CUDA error code.
int bpt_plucker_blocks() { return bpt::cluster_blocks<bpt::PluckerChop, false>(); }
int bpt_plucker_any_blocks() { return bpt::cluster_blocks<bpt::PluckerChop, true>(); }

}  // extern "C"
