// The threaded-DFS BVH walk that three kernels share: closest_bvh and
// any_bvh, the per-bounce PT wave kernel (pt_wave.cu), and the walk mode of
// the PT and BDPT megakernels (pt_megakernel.cu, bdpt_megakernel.cu), which
// replaces the clustered traversal of bpt_tpu's megakernels
// (bpt_tpu/ops/pallas/pt_kernel.py::make_clustered_closest,
// bdpt_kernel.py:169-186 with clusters.py's make_rolled_any_hit).
//
// The walk follows scene/bvh.py's preorder with skip links: a box hit at an
// internal node goes to the next node, a miss or a leaf to the skip link,
// so a lane needs no stack.  Visit order, NaN slab rules and the
// `t <= t_best` accept rule are those of ops/soa.py::_bvh_walk, so a kernel
// and the plain version take the same branch at every step and count the
// same node visits, box hits, triangle tests and accepted tests.  The scene
// (32 B a node, 48 B a triangle) is read from global memory through the
// read-only path; for the 91k-triangle coffee stand-in it is about 7.4 MB,
// resident in the 50 MB L2 cache.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace bpt {

struct Bvh {
  const float4* nodes;  // [2N]: (min xyz, max x), (max yz, skip, first*4 + count)
  const float4* tris;   // [3T]: (v0 xyz, e1 x), (e1 yz, e2 xy), (e2 z, normal)
  int N;
};

// The float64 walk's tables (wave_walk.cuh::WaveWalk64, pt_wave.cu's
// bvh64): a node is one 64-byte record, 64-byte aligned, that four 16-byte
// loads read from one half of a 128-byte line (the box and the links, 8 B
// of padding); a triangle is one 80-byte row (v0, e1, e2 and a padding
// double), five 16-byte loads.  The walk reads no normal: a float64 hit is
// completed by the caller (ops/soa.py::complete_hit).
struct Bvh64 {
  // [4N]: (min x, max x), (min y, max y), (min z, max z), (skip, first*4 +
  // count as two int32; padding)
  const double2* nodes;
  const double2* tris;  // [5T]: (v0 x, v0 y), (v0 z, e1 x), (e1 y, e1 z), (e2 x, e2 y), (e2 z, 0)
  int N;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// A lane's walk counters: node visits, box hits, triangle tests and
// accepted tests (exact, summed by the kernels into 64-bit counters).
struct TraceCounts {
  unsigned long long nodes = 0, boxes = 0, tests = 0, hits = 0;
};

// jnp.minimum / maximum propagate NaN, and bvh_closest then reads a NaN
// slab bound as unconstrained (-inf / +inf).
__device__ __forceinline__ void slab_axis(float lo_b, float hi_b, float o,
                                          float inv, float& lo, float& hi) {
  const float t0 = (lo_b - o) * inv;
  const float t1 = (hi_b - o) * inv;
  const bool nan = isnan(t0) || isnan(t1);
  lo = nan ? -inf_f() : fminf(t0, t1);
  hi = nan ? inf_f() : fmaxf(t0, t1);
}

// The same in double.
__device__ __forceinline__ void slab_axis(double lo_b, double hi_b, double o,
                                          double inv, double& lo, double& hi) {
  const double t0 = (lo_b - o) * inv;
  const double t1 = (hi_b - o) * inv;
  const bool nan = isnan(t0) || isnan(t1);
  lo = nan ? -inf_of<double>() : fmin(t0, t1);
  hi = nan ? inf_of<double>() : fmax(t0, t1);
}

// The clustered kernels' slab test of the box (lo3, hi3) at box[0..5]
// (cluster_wave.cu, plucker.cu; bpt_tpu/ops/pallas/clusters.py::_slab):
// entry clamped to T_MIN, exit to bound, NaN terms unconstrained.
__device__ __forceinline__ bool box_entered(const float* box, float ox, float oy,
                                            float oz, float ix, float iy, float iz,
                                            float bound) {
  float lox, hix, loy, hiy, loz, hiz;
  slab_axis(__ldg(box), __ldg(box + 3), ox, ix, lox, hix);
  slab_axis(__ldg(box + 1), __ldg(box + 4), oy, iy, loy, hiy);
  slab_axis(__ldg(box + 2), __ldg(box + 5), oz, iz, loz, hiz);
  const float enter = fmaxf(fmaxf(lox, loy), fmaxf(loz, T_MIN));
  const float exit_ = fminf(fminf(hix, hiy), fminf(hiz, bound));
  return exit_ > enter;
}

// The threaded-DFS walk of soa._bvh_walk over [tmin, tmax].  ANY = false:
// the closest hit (an accepted test shrinks the interval; t is inf and tri
// -1 on a miss; u, v are the winner's barycentrics).  ANY = true: the
// interval stays, a leaf tests all its triangles and a hit among them ends
// the walk; tri >= 0 on a hit.
template <bool ANY>
__device__ __forceinline__ void bvh_walk(const Bvh& g, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float tmin, float tmax,
                                         float& t_out, int& tri_out,
                                         float& u_out, float& v_out,
                                         TraceCounts& c) {
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float t_best = tmax, ub = 0.0f, vb = 0.0f;
  int tri = -1;
  int i = 0;
  while (i < g.N) {
    c.nodes += 1;
    const float4 a = __ldg(&g.nodes[2 * i]);
    const float4 b = __ldg(&g.nodes[2 * i + 1]);
    float lox, hix, loy, hiy, loz, hiz;
    slab_axis(a.x, a.w, ox, ix, lox, hix);
    slab_axis(a.y, b.x, oy, iy, loy, hiy);
    slab_axis(a.z, b.y, oz, iz, loz, hiz);
    const float t_enter = fmaxf(fmaxf(lox, loy), fmaxf(loz, tmin));
    const float t_exit = fminf(fminf(hix, hiy), fminf(hiz, t_best));
    const int skip = __float_as_int(b.z);
    if (!(t_exit > t_enter)) {
      i = skip;
      continue;
    }
    c.boxes += 1;
    const int fc = __float_as_int(b.w);
    const int cnt = fc & 3;
    if (cnt == 0) {  // internal node: descend
      i += 1;
      continue;
    }
    for (int k = fc >> 2, end = (fc >> 2) + cnt; k < end; ++k) {
      c.tests += 1;
      const float4 p0 = __ldg(&g.tris[3 * k]);
      const float4 p1 = __ldg(&g.tris[3 * k + 1]);
      const float4 p2 = __ldg(&g.tris[3 * k + 2]);
      const float tv[9] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x};
      float u, v;
      bool valid;
      const float t = moller_trumbore_uv(ox, oy, oz, dx, dy, dz, tv, u, v, valid);
      if (valid && t >= tmin && t <= t_best) {
        c.hits += 1;
        tri = k;
        if constexpr (!ANY) {
          t_best = t;
          ub = u;
          vb = v;
        }
      }
    }
    if (ANY && tri >= 0) break;
    i = skip;
  }
  t_out = tri >= 0 ? t_best : inf_f();
  tri_out = tri;
  u_out = ub;
  v_out = vb;
}

__device__ __forceinline__ void surface_of(const Bvh& g, const int* mat_id,
                                           int tri, float& gnx, float& gny,
                                           float& gnz, int& mat) {
  const float4 n = __ldg(&g.tris[3 * tri + 2]);
  gnx = n.y;
  gny = n.z;
  gnz = n.w;
  mat = __ldg(&mat_id[tri]);
}

// The walk as a hit provider (the interface of pt_shade.cuh::pt_bounce and
// of the BDPT megakernel): the closest hit over (T_MIN, inf), the hit
// triangle's normal and material, and the shadow any hit over
// [T_MIN, tmax].  Every walk adds its node visits, box hits and triangle
// tests to `c`; only the closest hits add their accepted tests, as
// bpt_tpu's clustered megakernels charge the shadow traversals to every
// counter but the triangle hits (bdpt_kernel.py:183-186, 239-250).  C is
// the caller's lane counters (TraceCounts or a type derived from it),
// which the caller reaches through `c` too, so that one reference, not
// two that may alias, carries every count.
template <class C>
struct WalkHit {
  Bvh g;
  const int* mat_id;
  C& c;

  __device__ __forceinline__ Hit operator()(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
    float t, u, v;
    int tri;
    bvh_walk<false>(g, ox, oy, oz, dx, dy, dz, T_MIN, inf_f(), t, tri, u, v, c);
    return Hit{tri, t};
  }

  __device__ __forceinline__ void surface(int k, float& gnx, float& gny,
                                          float& gnz, int& mat) const {
    surface_of(g, mat_id, k, gnx, gny, gnz, mat);
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) {
    TraceCounts s;
    float t, u, v;
    int tri;
    bvh_walk<true>(g, ox, oy, oz, dx, dy, dz, T_MIN, tmax, t, tri, u, v, s);
    c.nodes += s.nodes;
    c.boxes += s.boxes;
    c.tests += s.tests;
    return tri >= 0;
  }
};

// The megakernels' brute-force table in shared memory: v0(3) e1(3) e2(3)
// n(3) mat(1) a triangle.
constexpr int TRI_STRIDE = 13;

// The megakernels' brute-force provider over a [T * TRI_STRIDE] triangle
// table in shared memory: strict t < t_best keeps the first of equal hits.
// A closest hit counts T tests and one accepted test if it hits; a shadow
// ray counts T tests (the SMEM sweeps of bpt_tpu's megakernels,
// pt_kernel.py / bdpt_kernel.py:239-290).  C as for WalkHit.
template <class C>
struct BruteHit {
  const float* tri;
  int T;
  C& c;

  __device__ __forceinline__ Hit operator()(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
    c.tests += (unsigned long long)T;
    float t_hit = inf_f();
    int best = -1;
    for (int ti = 0; ti < T; ++ti) {
      bool valid;
      const float t = moller_trumbore(ox, oy, oz, dx, dy, dz, &tri[ti * TRI_STRIDE], valid);
      if (valid && t >= T_MIN && t < t_hit) {
        t_hit = t;
        best = ti;
      }
    }
    if (best >= 0) c.hits += 1;
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

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float tmax) {
    c.tests += (unsigned long long)T;
    for (int ti = 0; ti < T; ++ti) {
      bool valid;
      const float t = moller_trumbore(ox, oy, oz, dx, dy, dz, &tri[ti * TRI_STRIDE], valid);
      if (valid && t >= T_MIN && t <= tmax) return true;
    }
    return false;
  }
};

// Adds a warp's sum of v to *dst with one atomic.
__device__ __forceinline__ void warp_add(unsigned long long v,
                                         unsigned long long* dst) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, v);
}

}  // namespace bpt
