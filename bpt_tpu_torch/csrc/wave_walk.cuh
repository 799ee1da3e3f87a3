// The BVH walk of the refilling wave kernels closest_bvh and any_bvh
// (pt_wave.cu): one lane's closest hit over (T_MIN, inf) or any hit over
// [T_MIN, tmax], stepped by a persistent warp that refills its finished
// lanes (pt_wave.cu; walk_sched.cuh::warp_take_n).
//
// It visits the nodes of bvh_walk.cuh::bvh_walk<ANY> in the same order,
// with the same Möller–Trumbore arithmetic, the same `t <= t_best` accept
// rule and the same counts, so every lane's answer and every counter is
// bitwise that of bvh_walk (and of ops/soa.py::_bvh_walk's or bvh_any's).
// A step is one pass of bvh_walk's loop body: a node, and its triangles if
// it is a leaf whose box the lane entered.  The one difference is the slab
// test of a ray whose origin and 1/d are finite (decided once a ray) in a
// scene whose node bounds hold no NaN: inv is then not 0, so (lo - o) * inv
// cannot be NaN and slab_axis's NaN selects would be dead code.  Other
// rays take slab_axis.
#pragma once

#include "bvh_walk.cuh"
#include "walk_sched.cuh"

namespace bpt {

// A warp refills when at least REFILL of its lanes are free, and looks for
// free lanes after every STEPS steps of its lanes' walks (a lane whose walk
// ends sooner waits for the rest of them): both chosen on the card
// (PERF.md §6).
constexpr int REFILL = 8;
constexpr int STEPS = 16;

// slab_axis for finite operands, where t0 and t1 are never NaN.
__device__ __forceinline__ void slab_finite(float lo_b, float hi_b, float o,
                                            float inv, float& lo, float& hi) {
  const float t0 = (lo_b - o) * inv;
  const float t1 = (hi_b - o) * inv;
  lo = fminf(t0, t1);
  hi = fmaxf(t0, t1);
}

// ANY = false: the closest hit (an accepted test shrinks the interval).
// ANY = true: the interval stays, a leaf tests all its triangles and a hit
// among them ends the walk after that leaf (tri >= 0 on a hit).
template <bool ANY>
struct WaveWalk {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float t_best, u, v;
  int tri;
  int i;      // the next node; N when the walk has ended
  bool fast;  // slab_finite: origin and 1/d finite, node bounds without NaN

  __device__ __forceinline__ void start(float ox_, float oy_, float oz_, float dx_,
                                        float dy_, float dz_, float tmax, bool bounds_ok) {
    ox = ox_;
    oy = oy_;
    oz = oz_;
    dx = dx_;
    dy = dy_;
    dz = dz_;
    ix = 1.0f / dx;
    iy = 1.0f / dy;
    iz = 1.0f / dz;
    t_best = tmax;
    u = 0.0f;
    v = 0.0f;
    tri = -1;
    i = 0;
    fast = bounds_ok && isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(ix) &&
           isfinite(iy) && isfinite(iz);
  }

  __device__ __forceinline__ float t() const { return tri >= 0 ? t_best : inf_f(); }

  // One step of the walk.  Returns true when the walk has ended.
  __device__ __forceinline__ bool step(const Bvh& g, TraceCounts& c) {
    c.nodes += 1;
    const float4 a = __ldg(&g.nodes[2 * i]);
    const float4 b = __ldg(&g.nodes[2 * i + 1]);
    float lox, hix, loy, hiy, loz, hiz;
    if (fast) {
      slab_finite(a.x, a.w, ox, ix, lox, hix);
      slab_finite(a.y, b.x, oy, iy, loy, hiy);
      slab_finite(a.z, b.y, oz, iz, loz, hiz);
    } else {
      slab_axis(a.x, a.w, ox, ix, lox, hix);
      slab_axis(a.y, b.x, oy, iy, loy, hiy);
      slab_axis(a.z, b.y, oz, iz, loz, hiz);
    }
    const float t_enter = fmaxf(fmaxf(lox, loy), fmaxf(loz, T_MIN));
    const float t_exit = fminf(fminf(hix, hiy), fminf(hiz, t_best));
    const int skip = __float_as_int(b.z);
    if (!(t_exit > t_enter)) {
      i = skip;
      return i >= g.N;
    }
    c.boxes += 1;
    const int fc = __float_as_int(b.w);
    const int cnt = fc & 3;
    if (cnt == 0) {  // internal node: descend
      i += 1;
      return i >= g.N;
    }
    for (int k = fc >> 2, end = (fc >> 2) + cnt; k < end; ++k) {
      c.tests += 1;
      const float4 p0 = __ldg(&g.tris[3 * k]);
      const float4 p1 = __ldg(&g.tris[3 * k + 1]);
      const float4 p2 = __ldg(&g.tris[3 * k + 2]);
      const float tv[9] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x};
      float tu, tw;
      bool valid;
      const float t = moller_trumbore_uv(ox, oy, oz, dx, dy, dz, tv, tu, tw, valid);
      if (valid && t >= T_MIN && t <= t_best) {
        c.hits += 1;
        tri = k;
        if constexpr (!ANY) {
          t_best = t;
          u = tu;
          v = tw;
        }
      }
    }
    if (ANY && tri >= 0) return true;
    i = skip;
    return i >= g.N;
  }
};

}  // namespace bpt
