// Brute-force closest and any hit of small scenes for Hopper (sm_90a), in
// float32 and float64.
//
// closest_tri replaces the Pallas kernel
// bpt_tpu/ops/pallas/intersect.py::closest_pallas: every ray against every
// triangle of the scene, over its own [tmin, tmax]; out t (inf on a miss),
// tri (-1 on a miss), u, v (0 on a miss).  A later triangle replaces the
// best hit only on t < t_best, so an exact tie keeps the first triangle, as
// torch.argmin does in ops/soa.py::brute_closest and the Pallas kernel's
// strict-< update does.
// any_tri replaces intersect.py::any_pallas: a hit anywhere in [tmin, tmax]
// (BDPT's connection shadow rays; a masked lane has tmax 0 < tmin).
//
// What bounds them on the H100: a small scene has at most 256 triangles
// (scene/builder.py gives larger ones a BVH), so a ray costs T Moller-
// Trumbore tests of ~52 FP32 operations against 32-36 bytes of ray in and
// 1-16 bytes out.  At the render's shapes (24 triangles, 4M rays or 42M
// shadow lanes, most of them dead) the launches are short and latency- and
// launch-bound rather than bound by FP32 issue or device memory.
//
// Design: one thread per ray.  Each block stages the (v0, e1, e2) table in
// shared memory, TILE triangles at a time (all of a small scene in one
// tile: 9 KB in float32, 18 KB in float64), and every thread then reads the
// same triangle in the same step, a broadcast without bank conflicts: the
// Hopper counterpart of the Pallas kernels' scalar-prefetched SMEM table.
// The triangles run in index order with bpt_tpu's operation order
// (intersect.py:56-76) and MT_EPSILON; built with -fmad=false, the kernel
// rounds every operation as the plain PyTorch version does, so t ties at a
// BDPT connection's endpoint (ref_vis: t == max_t, inclusive) resolve alike
// on both sides.  A lane with !(tmin <= tmax) can hit nothing and tests
// nothing; a block of such lanes returns before staging the table, which
// matters for shadow waves where most pairs are dead.  The any hit stops at
// its first hit.  The scalar type is a template parameter: the float64
// instantiation serves --f64 renders on the card.  The TPU's 128-lane tiles
// and the padded tail (tmax = -1) do not carry over: the grid covers B and
// the last block masks its ragged edge.
#include <cuda_runtime.h>

#include <cstdint>

namespace bpt {

constexpr int TRI_BLOCK = 128;
constexpr int TRI_TILE = 256;  // triangles staged in shared memory at once

template <typename F>
__device__ __forceinline__ F inf_of() {
  return F(__int_as_float(0x7f800000));
}

// Moller-Trumbore of ray (o, d) against triangle tv = (v0, e1, e2) in the
// operation order of bpt_tpu/ops/pallas/intersect.py:56-76; valid = the
// reference's acceptance test minus the t interval.
template <typename F>
__device__ __forceinline__ F mt_test(const F* tv, F ox, F oy, F oz, F dx, F dy,
                                     F dz, F& u, F& v, bool& valid) {
  const F v0x = tv[0], v0y = tv[1], v0z = tv[2];
  const F e1x = tv[3], e1y = tv[4], e1z = tv[5];
  const F e2x = tv[6], e2y = tv[7], e2z = tv[8];
  const F px = dy * e2z - dz * e2y;
  const F py = dz * e2x - dx * e2z;
  const F pz = dx * e2y - dy * e2x;
  const F det = e1x * px + e1y * py + e1z * pz;
  const F inv = F(1) / det;
  const F tx = ox - v0x;
  const F ty = oy - v0y;
  const F tz = oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  const F qx = ty * e1z - tz * e1y;
  const F qy = tz * e1x - tx * e1z;
  const F qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv;
  const F t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  valid = (fabs(det) >= F(1e-8)) && (u >= F(0)) && (u <= F(1)) && (v >= F(0)) &&
          (u + v <= F(1));
  return t;
}

template <typename F>
struct TriParams {
  int B, T;
  const F* tri;  // [T * 9] v0, e1, e2 of each triangle
  const F* o[3];
  const F* d[3];
  const F* tmin;
  const F* tmax;
  F* t;                // closest: [B]
  int* tri_out;        // closest: [B]
  F* u;                // closest: [B]
  F* v;                // closest: [B]
  unsigned char* hit;  // any: [B] bool
};

// Stages triangles [base, base + n) of the table into s_tri.
template <typename F>
__device__ __forceinline__ void stage(const TriParams<F>& p, F* s_tri, int base, int n) {
  for (int k = threadIdx.x; k < n * 9; k += blockDim.x) s_tri[k] = p.tri[base * 9 + k];
  __syncthreads();
}

template <typename F>
__global__ void __launch_bounds__(TRI_BLOCK) closest_tri(const TriParams<F> p) {
  __shared__ F s_tri[TRI_TILE * 9];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  F ox = 0, oy = 0, oz = 0, dx = 0, dy = 0, dz = 0, tmin = 0, tmax = 0;
  bool live = false;
  if (lane < p.B) {
    tmin = p.tmin[lane];
    tmax = p.tmax[lane];
    live = tmin <= tmax;
    if (live) {
      ox = p.o[0][lane], oy = p.o[1][lane], oz = p.o[2][lane];
      dx = p.d[0][lane], dy = p.d[1][lane], dz = p.d[2][lane];
    }
  }
  F t_best = inf_of<F>(), ub = 0, vb = 0;
  int tri = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < p.T; base += TRI_TILE) {
      const int n = min(TRI_TILE, p.T - base);
      stage(p, s_tri, base, n);
      if (live) {
        for (int k = 0; k < n; ++k) {
          F u, v;
          bool valid;
          const F t = mt_test(&s_tri[9 * k], ox, oy, oz, dx, dy, dz, u, v, valid);
          if (valid && t >= tmin && t <= tmax && t < t_best) {
            t_best = t;
            tri = base + k;
            ub = u;
            vb = v;
          }
        }
      }
      __syncthreads();  // the next tile overwrites s_tri
    }
  }
  if (lane < p.B) {
    p.t[lane] = t_best;
    p.tri_out[lane] = tri;
    p.u[lane] = ub;
    p.v[lane] = vb;
  }
}

template <typename F>
__global__ void __launch_bounds__(TRI_BLOCK) any_tri(const TriParams<F> p) {
  __shared__ F s_tri[TRI_TILE * 9];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  F ox = 0, oy = 0, oz = 0, dx = 0, dy = 0, dz = 0, tmin = 0, tmax = 0;
  bool live = false;
  if (lane < p.B) {
    tmin = p.tmin[lane];
    tmax = p.tmax[lane];
    live = tmin <= tmax;
    if (live) {
      ox = p.o[0][lane], oy = p.o[1][lane], oz = p.o[2][lane];
      dx = p.d[0][lane], dy = p.d[1][lane], dz = p.d[2][lane];
    }
  }
  bool found = false;
  for (int base = 0; base < p.T; base += TRI_TILE) {
    if (!__syncthreads_or(live && !found)) break;  // uniform across the block
    const int n = min(TRI_TILE, p.T - base);
    stage(p, s_tri, base, n);
    if (live && !found) {
      for (int k = 0; k < n; ++k) {
        F u, v;
        bool valid;
        const F t = mt_test(&s_tri[9 * k], ox, oy, oz, dx, dy, dz, u, v, valid);
        if (valid && t >= tmin && t <= tmax) {
          found = true;
          break;
        }
      }
    }
    __syncthreads();  // the next tile overwrites s_tri
  }
  if (lane < p.B) p.hit[lane] = found;
}

template <typename F>
TriParams<F> tri_params(int B, int T, const void* tri, const void* const* rays,
                        const void* tmin, const void* tmax) {
  TriParams<F> p{};
  p.B = B;
  p.T = T;
  p.tri = (const F*)tri;
  for (int k = 0; k < 3; ++k) {
    p.o[k] = (const F*)rays[k];
    p.d[k] = (const F*)rays[3 + k];
  }
  p.tmin = (const F*)tmin;
  p.tmax = (const F*)tmax;
  return p;
}

inline int tri_grid(int B) { return (B + TRI_BLOCK - 1) / TRI_BLOCK; }

template <typename F>
void launch_closest(int B, int T, const void* tri, const void* const* rays,
                    const void* tmin, const void* tmax, void* t, int* tri_out,
                    void* u, void* v, cudaStream_t stream) {
  TriParams<F> p = tri_params<F>(B, T, tri, rays, tmin, tmax);
  p.t = (F*)t;
  p.tri_out = tri_out;
  p.u = (F*)u;
  p.v = (F*)v;
  closest_tri<F><<<tri_grid(B), TRI_BLOCK, 0, stream>>>(p);
}

template <typename F>
void launch_any(int B, int T, const void* tri, const void* const* rays,
                const void* tmin, const void* tmax, unsigned char* hit,
                cudaStream_t stream) {
  TriParams<F> p = tri_params<F>(B, T, tri, rays, tmin, tmax);
  p.hit = hit;
  any_tri<F><<<tri_grid(B), TRI_BLOCK, 0, stream>>>(p);
}

}  // namespace bpt

extern "C" {

// Launch on `stream`; each returns cudaGetLastError() after the launch
// (0 = launched).  All pointers are device pointers to float64 data when
// f64 != 0, else float32.
int bpt_closest_tri(int f64, int B, int T, const void* tri, const void* ox,
                    const void* oy, const void* oz, const void* dx,
                    const void* dy, const void* dz, const void* tmin,
                    const void* tmax, void* t, int* tri_out, void* u, void* v,
                    void* stream) {
  const void* rays[6] = {ox, oy, oz, dx, dy, dz};
  if (B > 0) {
    if (f64) {
      bpt::launch_closest<double>(B, T, tri, rays, tmin, tmax, t, tri_out, u, v,
                                  (cudaStream_t)stream);
    } else {
      bpt::launch_closest<float>(B, T, tri, rays, tmin, tmax, t, tri_out, u, v,
                                 (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

int bpt_any_tri(int f64, int B, int T, const void* tri, const void* ox,
                const void* oy, const void* oz, const void* dx, const void* dy,
                const void* dz, const void* tmin, const void* tmax,
                unsigned char* hit, void* stream) {
  const void* rays[6] = {ox, oy, oz, dx, dy, dz};
  if (B > 0) {
    if (f64) {
      bpt::launch_any<double>(B, T, tri, rays, tmin, tmax, hit, (cudaStream_t)stream);
    } else {
      bpt::launch_any<float>(B, T, tri, rays, tmin, tmax, hit, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
