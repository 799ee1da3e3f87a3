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
//
// WaveWalk64 is the same walk in double over each lane's own [tmin, tmax]
// (pt_wave.cu's bvh64<ANY>): bpt_tpu computes every
// float64 hit of a scene with a BVH with its jnp walks soa.bvh_closest /
// bvh_any, whose answers and counts it gives.  It reads the Bvh64 tables
// and tests with common.cuh's mt_test<double>; its slab entry is clamped
// to tmin, its exit to t_best, and it accepts t >= tmin && t <= t_best.
// fmin / fmax return the operand that is not NaN where torch.minimum /
// maximum propagate it, so a lane whose interval holds a NaN starts from
// the empty interval (inf, -inf): the plain walk's NaN bound fails the
// root's test, and so does that.  The float32 walk is written apart so
// that its kernels compile to the instructions they had before.
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

__device__ __forceinline__ void slab_finite(double lo_b, double hi_b, double o,
                                            double inv, double& lo, double& hi) {
  const double t0 = (lo_b - o) * inv;
  const double t1 = (hi_b - o) * inv;
  lo = fmin(t0, t1);
  hi = fmax(t0, t1);
}

// WaveWalk's float64 counterpart, over the lane's own [tmin, tmax].
template <bool ANY>
struct WaveWalk64 {
  double ox, oy, oz, dx, dy, dz, ix, iy, iz;
  double tmin, t_best, u, v;
  int tri;
  int i;      // the next node; N when the walk has ended
  bool fast;  // slab_finite: origin and 1/d finite, node bounds without NaN

  __device__ __forceinline__ void start(double ox_, double oy_, double oz_, double dx_,
                                        double dy_, double dz_, double tmin_, double tmax,
                                        bool bounds_ok) {
    ox = ox_;
    oy = oy_;
    oz = oz_;
    dx = dx_;
    dy = dy_;
    dz = dz_;
    ix = 1.0 / dx;
    iy = 1.0 / dy;
    iz = 1.0 / dz;
    tmin = tmin_;
    t_best = tmax;
    if (isnan(tmin) || isnan(t_best)) {  // the plain walk's NaN bound: no box is entered
      tmin = inf_of<double>();
      t_best = -inf_of<double>();
    }
    u = 0.0;
    v = 0.0;
    tri = -1;
    i = 0;
    fast = bounds_ok && isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(ix) &&
           isfinite(iy) && isfinite(iz);
  }

  __device__ __forceinline__ double t() const { return tri >= 0 ? t_best : inf_of<double>(); }

  // One step of the walk.  Returns true when the walk has ended.
  __device__ __forceinline__ bool step(const Bvh64& g, TraceCounts& c) {
    c.nodes += 1;
    const double2 x = __ldg(&g.boxes[3 * i]);
    const double2 y = __ldg(&g.boxes[3 * i + 1]);
    const double2 z = __ldg(&g.boxes[3 * i + 2]);
    const int2 link = __ldg(&g.links[i]);  // (skip, first*4 + count)
    double lox, hix, loy, hiy, loz, hiz;
    if (fast) {
      slab_finite(x.x, x.y, ox, ix, lox, hix);
      slab_finite(y.x, y.y, oy, iy, loy, hiy);
      slab_finite(z.x, z.y, oz, iz, loz, hiz);
    } else {
      slab_axis(x.x, x.y, ox, ix, lox, hix);
      slab_axis(y.x, y.y, oy, iy, loy, hiy);
      slab_axis(z.x, z.y, oz, iz, loz, hiz);
    }
    const double t_enter = fmax(fmax(lox, loy), fmax(loz, tmin));
    const double t_exit = fmin(fmin(hix, hiy), fmin(hiz, t_best));
    if (!(t_exit > t_enter)) {
      i = link.x;
      return i >= g.N;
    }
    c.boxes += 1;
    const int cnt = link.y & 3;
    if (cnt == 0) {  // internal node: descend
      i += 1;
      return i >= g.N;
    }
    for (int k = link.y >> 2, end = (link.y >> 2) + cnt; k < end; ++k) {
      c.tests += 1;
      const double* p = g.tris + 9 * (size_t)k;
      const double tv[9] = {__ldg(p),     __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4),
                            __ldg(p + 5), __ldg(p + 6), __ldg(p + 7), __ldg(p + 8)};
      double tu, tw;
      bool valid;
      const double t = mt_test<double>(tv, ox, oy, oz, dx, dy, dz, tu, tw, valid);
      if (valid && t >= tmin && t <= t_best) {
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
    i = link.x;
    return i >= g.N;
  }
};

}  // namespace bpt
