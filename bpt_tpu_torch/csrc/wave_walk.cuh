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
// (pt_wave.cu's bvh64): bpt_tpu computes every float64 hit of a scene with
// a BVH with its jnp walks soa.bvh_closest / bvh_any, whose answers and
// counts it gives.  Its slab entry is clamped to tmin, its exit to t_best,
// and it accepts t >= tmin && t <= t_best.  fmin / fmax return the operand
// that is not NaN where torch.minimum / maximum propagate it, so a lane
// whose interval holds a NaN starts from the empty interval (inf, -inf):
// the plain walk's NaN bound fails the root's test, and so does that.
//
// What holds it on the H100 is the latency of a step, not warps in flight,
// bytes or FP64 issue: a node's load depends on the previous step's test,
// 15 of a float64 coffee bdpt-mis render's 19 closest launches keep under
// a quarter of their lanes live and last as long as their longest walks
// (~1,000 node visits a ray), and a walk alone takes 0.28-0.30 µs a node
// visit (PERF.md §6).  So its design shortens the chain of a step
// and keeps the registers at 6 blocks an SM without spills:
// - one 64-byte node record (box and links, Bvh64) of four 16-byte loads
//   and one 80-byte triangle row of five;
// - for a ray with a finite origin and finite non-zero 1/d over finite
//   boxes whose min <= max (most rays of every scene), slab_ord: the sign
//   of 1/d picks each slab's pair (rounding is monotone), and the entry
//   and exit take one compare and a select each (max_nn / min_nn), where
//   fmin / fmax of double cost a compare, selects and a NaN fix-up; every
//   other ray takes slab_axis;
// - a triangle test that stops at |det| < 1e-8 or at u or v outside the
//   triangle, where mt_test<double>'s valid is false;
// - no (u, v) in the closest walk's loop: the winner's test again at the
//   walk's end gives the bits its accepted test gave; lane counters in 32
//   bits (TraceCounts32).
// Each keeps every answer and count bitwise that of the plain walk.  The
// float32 walk is written apart so that its kernels compile to the
// instructions they had before.
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

// slab_axis over a finite box whose lo_b <= hi_b, for finite o and a
// finite inv that is not 0: rounding is monotone, so t0 <= t1 where inv > 0
// and t0 >= t1 where inv < 0, neither NaN, and the ray's sign of inv (neg)
// picks the pair.  lo and hi are slab_axis's but for the sign of a zero,
// which no comparison of the walk sees.
__device__ __forceinline__ void slab_ord(double lo_b, double hi_b, double o, double inv,
                                         bool neg, double& lo, double& hi) {
  const double t0 = (lo_b - o) * inv;
  const double t1 = (hi_b - o) * inv;
  lo = neg ? t1 : t0;
  hi = neg ? t0 : t1;
}

// fmax / fmin of operands that are not NaN: one compare and a select.
__device__ __forceinline__ double max_nn(double a, double b) { return a < b ? b : a; }
__device__ __forceinline__ double min_nn(double a, double b) { return b < a ? b : a; }

// A lane's walk counters in 32 bits (the float64 kernels).  A walk visits
// each node at most once (i only grows) and tests each triangle at most
// once, so it adds under 2^31 to every count (N, T < 2^31); the kernel
// flushes a lane's counts into the 64-bit device counters whenever one has
// reached 2^31 at the end of a walk, so none wraps, whatever B.
struct TraceCounts32 {
  unsigned nodes = 0, boxes = 0, tests = 0, hits = 0;
};

// WaveWalk's float64 counterpart, over the lane's own [tmin, tmax].
template <bool ANY>
struct WaveWalk64 {
  double ox, oy, oz, dx, dy, dz, ix, iy, iz;
  double tmin, t_best;
  int tri;
  int i;                  // the next node; N when the walk has ended
  bool ord;               // slab_ord: origin and 1/d finite, 1/d not 0, bounds_ord
  bool negx, negy, negz;  // 1/d < 0 (slab_ord)

  __device__ __forceinline__ void start(double ox_, double oy_, double oz_, double dx_,
                                        double dy_, double dz_, double tmin_, double tmax,
                                        bool bounds_ord) {
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
    tri = -1;
    i = 0;
    ord = bounds_ord && isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(ix) &&
          isfinite(iy) && isfinite(iz) && ix != 0.0 && iy != 0.0 && iz != 0.0;
    negx = ix < 0.0;
    negy = iy < 0.0;
    negz = iz < 0.0;
  }

  __device__ __forceinline__ double t() const { return tri >= 0 ? t_best : inf_of<double>(); }

  // The closest hit's barycentrics: 0 on a miss; the winner's test again
  // (mt_test<double>, the operations of accepts in their order) on the
  // same operands, which gives the bits its accepted test gave.
  __device__ __forceinline__ void uv(const Bvh64& g, double& u, double& v) const {
    u = 0.0;
    v = 0.0;
    if (tri >= 0) {
      const double2* row = g.tris + 5 * (size_t)tri;
      const double2 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
                    e = __ldg(row + 3), f = __ldg(row + 4);
      const double tv[9] = {a.x, a.y, b.x, b.y, c.x, c.y, e.x, e.y, f.x};
      bool valid;
      mt_test<double>(tv, ox, oy, oz, dx, dy, dz, u, v, valid);
    }
  }

  // Whether triangle k's test is accepted ([tmin, t_best]), and its t:
  // mt_test<double>'s operations in its order, stopping as soon as |det| <
  // 1e-8 or u or v falls outside the triangle, where its valid is false.
  __device__ __forceinline__ bool accepts(const double2* tris, int k, double& t) const {
    const double2* row = tris + 5 * (size_t)k;
    const double2 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2), e = __ldg(row + 3),
                  f = __ldg(row + 4);
    const double v0x = a.x, v0y = a.y, v0z = b.x;
    const double e1x = b.y, e1y = c.x, e1z = c.y;
    const double e2x = e.x, e2y = e.y, e2z = f.x;
    const double px = dy * e2z - dz * e2y;
    const double py = dz * e2x - dx * e2z;
    const double pz = dx * e2y - dy * e2x;
    const double det = e1x * px + e1y * py + e1z * pz;
    if (!(fabs(det) >= 1e-8)) return false;
    const double inv = 1.0 / det;
    const double tx = ox - v0x;
    const double ty = oy - v0y;
    const double tz = oz - v0z;
    const double u = (tx * px + ty * py + tz * pz) * inv;
    if (!(u >= 0.0 && u <= 1.0)) return false;
    const double qx = ty * e1z - tz * e1y;
    const double qy = tz * e1x - tx * e1z;
    const double qz = tx * e1y - ty * e1x;
    const double v = (dx * qx + dy * qy + dz * qz) * inv;
    if (!(v >= 0.0 && u + v <= 1.0)) return false;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    return t >= tmin && t <= t_best;
  }

  // One step of the walk.  Returns true when the walk has ended.
  __device__ __forceinline__ bool step(const Bvh64& g, TraceCounts32& c) {
    c.nodes += 1;
    const double2* node = g.nodes + 4 * (size_t)i;
    const double2 x = __ldg(node);
    const double2 y = __ldg(node + 1);
    const double2 z = __ldg(node + 2);
    const int2 link = __ldg(reinterpret_cast<const int2*>(node + 3));  // (skip, first*4 + count)
    double t_enter, t_exit;
    if (ord) {
      double lox, hix, loy, hiy, loz, hiz;
      slab_ord(x.x, x.y, ox, ix, negx, lox, hix);
      slab_ord(y.x, y.y, oy, iy, negy, loy, hiy);
      slab_ord(z.x, z.y, oz, iz, negz, loz, hiz);
      t_enter = max_nn(max_nn(lox, loy), max_nn(loz, tmin));
      t_exit = min_nn(min_nn(hix, hiy), min_nn(hiz, t_best));
    } else {
      double lox, hix, loy, hiy, loz, hiz;
      slab_axis(x.x, x.y, ox, ix, lox, hix);
      slab_axis(y.x, y.y, oy, iy, loy, hiy);
      slab_axis(z.x, z.y, oz, iz, loz, hiz);
      t_enter = fmax(fmax(lox, loy), fmax(loz, tmin));
      t_exit = fmin(fmin(hix, hiy), fmin(hiz, t_best));
    }
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
      double t;
      if (accepts(g.tris, k, t)) {
        c.hits += 1;
        tri = k;
        if constexpr (!ANY) t_best = t;
      }
    }
    if (ANY && tri >= 0) return true;
    i = link.x;
    return i >= g.N;
  }
};

}  // namespace bpt
