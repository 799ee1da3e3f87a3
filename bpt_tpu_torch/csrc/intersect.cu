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
// What bounds them on the H100: FP32 issue on the live rays, and nothing
// on the dead ones.  A small scene has at most 256 triangles
// (scene/builder.py gives larger ones a BVH); a live ray costs up to T
// Moller-Trumbore tests of ~80 instructions (-fmad=false, an IEEE 1/det)
// against 32-64 bytes of ray in and 1-32 bytes out, a dead lane (!(tmin <=
// tmax)) costs its interval in and its miss out.  At the ref_vis render's
// shapes (24 triangles; 4M camera lanes, 42M shadow lanes [S_l, B] row by
// row, rows sparser with the light vertex: 31% live at camera vertex 1)
// a thread a lane on a grid over B spent its time on warps holding a few
// live lanes, each waiting for its slowest: the any hit stops at a live
// ray's first hit (13.7 tests of 24 on average), a miss tests all T
// (PERF.md §6).
//
// Design: a persistent grid (the blocks the card holds at once, from the
// occupancy query; walk_sched.cuh) whose warps hold live rays only.  Each
// block stages the (v0, e1, e2) table in shared memory once (9 KB in
// float32, 18 KB in float64) and crosses one barrier; after that its warps
// run on their own.  A warp takes a chunk of consecutive lanes from the
// launch's work counter (warp_take_n) and reads it 32 lanes at a time,
// coalesced, as its threads need rays: a dead lane gets its miss written
// at once and holds no thread, a live one goes to the warp's ring of
// pending lanes in shared memory, from which free threads take rays by
// rank (rank_in).  The chunk is about B / (TRI_CHUNKS x the grid's warps)
// lanes, 32 to 1024, so that a sparse wave takes few atomics (chunks of 32
// lanes cost the shadow wave 70%) and a dense one balances.  The any hit's
// loop is flat: a step is one triangle test of each busy thread's ray, a
// thread whose ray has its answer writes it and is free, and every
// ANY_STEPS steps the warp hands out pending rays if ANY_REFILL of its
// threads are free, so a warp is not held for its longest ray (a lockstep
// sweep ran 20-25% slower, a look after every step as slow).  The closest
// hit, whose live rays all test every triangle, refills only when all 32
// threads are free (CLOSEST_REFILL): its threads sweep in lockstep, and
// every thread of a warp reads the same triangle (a broadcast); a fully
// live launch runs 5-10% slower so than a thread a lane (PERF.md §6-7).
// The any hit's threads read different rows: the 9-word row stride is
// odd, so in float32
// distinct triangles mod 32 fall in distinct banks; a float64 row is 18
// words, and the 16 threads of a 64-bit access phase read distinct bank
// pairs for distinct triangles mod 16.  A ray tests its triangles in index
// order with bpt_tpu's operation order (intersect.py:56-76) and
// MT_EPSILON, the strict < on t_best and the inclusive [tmin, tmax]; built
// with -fmad=false, the kernel rounds every operation as the plain PyTorch
// version does, so t ties at a BDPT connection's endpoint (ref_vis: t ==
// max_t, inclusive) resolve alike on both sides, and the schedule changes
// no bit of any answer.  The scalar type is a template parameter: the
// float64 instantiation serves --f64 renders on the card.  The TPU's
// 128-lane tiles and the padded tail (tmax = -1) do not carry over.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "walk_sched.cuh"

namespace bpt {

constexpr int TRI_BLOCK = 128;
constexpr int TRI_TILE = 256;  // triangles staged in shared memory: a whole scene
constexpr int TRI_RING = 64;   // pending live lanes a warp holds (< 32 + 32)
constexpr int TRI_CHUNKS = 8;  // chunks a launch holds for each warp of its grid
// A warp hands out pending rays once this many of its threads are free,
// and a thread of the any hit's flat loop takes up to ANY_STEPS steps
// between two looks: chosen on the card (PERF.md §6; 1, 8 or 16 steps and
// 1, 8 or 16 threads measured too).
constexpr int ANY_REFILL = 4;
constexpr int ANY_STEPS = 4;
constexpr int CLOSEST_REFILL = 32;

template <typename F>
struct TriParams {
  int B, T;            // lanes, triangles (T <= TRI_TILE)
  int chunk;           // lanes a warp takes from the work counter at once
  const F* tri;        // [T * 9] v0, e1, e2 of each triangle
  const F* o[3];
  const F* d[3];
  const F* tmin;
  const F* tmax;
  F* t;                // closest: [B]
  int* tri_out;        // closest: [B]
  F* u;                // closest: [B]
  F* v;                // closest: [B]
  unsigned char* hit;  // any: [B] bool
  unsigned long long* next;  // the launch's work counter, zeroed by the wrapper
};

// The answer of lane k without a hit.
template <typename F, bool ANY>
__device__ __forceinline__ void write_miss(const TriParams<F>& p, int k) {
  if constexpr (ANY) {
    p.hit[k] = 0;
  } else {
    p.t[k] = inf_of<F>();
    p.tri_out[k] = -1;
    p.u[k] = F(0);
    p.v[k] = F(0);
  }
}

// One thread's ray: its interval, its next triangle k and its best hit.
template <typename F, bool ANY>
struct TriRay {
  F ox, oy, oz, dx, dy, dz, tmin, tmax;
  F t_best, ub, vb;
  int tri, k;

  __device__ __forceinline__ void start(const TriParams<F>& p, int r) {
    ox = p.o[0][r];
    oy = p.o[1][r];
    oz = p.o[2][r];
    dx = p.d[0][r];
    dy = p.d[1][r];
    dz = p.d[2][r];
    tmin = p.tmin[r];
    tmax = p.tmax[r];
    t_best = inf_of<F>();
    ub = F(0);
    vb = F(0);
    tri = -1;
    k = 0;
  }

  // Tests the next triangle; true once the ray's answer is known.
  __device__ __forceinline__ bool step(const F* s_tri, int T) {
    F u, v;
    bool valid;
    const F t = mt_test(&s_tri[9 * k], ox, oy, oz, dx, dy, dz, u, v, valid);
    if (valid && t >= tmin && t <= tmax) {
      if constexpr (ANY) {
        tri = k;
        return true;
      } else if (t < t_best) {
        t_best = t;
        tri = k;
        ub = u;
        vb = v;
      }
    }
    return ++k == T;
  }

  __device__ __forceinline__ void finish(const TriParams<F>& p, int r) const {
    if constexpr (ANY) {
      p.hit[r] = tri >= 0;
    } else {
      p.t[r] = t_best;
      p.tri_out[r] = tri;
      p.u[r] = ub;
      p.v[r] = vb;
    }
  }
};

// A warp's supply of live lanes (warp-uniform): the rest [cur, end) of the
// chunk it took last, and the ring positions [head, tail) of the live
// lanes read from it and not yet handed to a thread.  The work counter
// may hold lanes while the last chunk ended short of B.
struct Feed {
  int cur = 0, end = 0;
  int head = 0, tail = 0;

  __device__ __forceinline__ bool has_lanes(int B) const { return cur < end || end < B; }
};

// Reads the warp's next 32 lanes, taking a new chunk when the last is
// used up: a dead lane gets its miss, a live one goes to the ring.  Called
// by every thread of the warp.
template <typename F, bool ANY>
__device__ __forceinline__ void scan(const TriParams<F>& p, Feed& f, int* ring) {
  if (f.cur >= f.end) {
    const long long base = warp_take_n(p.next, p.chunk);
    f.cur = (int)min(base, (long long)p.B);
    f.end = (int)min(base + p.chunk, (long long)p.B);
  }
  const int k = f.cur + (threadIdx.x & 31);
  const bool in = k < f.end;
  const bool live = in && p.tmin[k] <= p.tmax[k];
  if (in && !live) write_miss<F, ANY>(p, k);
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (live) ring[(f.tail + rank_in(m)) & (TRI_RING - 1)] = k;
  f.tail += __popc(m);
  f.cur += 32;
}

template <typename F, bool ANY, int REFILL>
__device__ __forceinline__ void tri_hits(const TriParams<F>& p) {
  __shared__ F s_tri[TRI_TILE * 9];
  __shared__ int s_ring[TRI_BLOCK / 32][TRI_RING];
  for (int k = threadIdx.x; k < p.T * 9; k += TRI_BLOCK) s_tri[k] = p.tri[k];
  __syncthreads();  // the block's one barrier
  int* ring = s_ring[threadIdx.x >> 5];
  Feed f;
  TriRay<F, ANY> ray;
  int r = -1;  // the thread's lane; -1 when the thread is free
  while (true) {
    __syncwarp();
    const unsigned busy = __ballot_sync(0xffffffffu, r >= 0);
    const int n_free = 32 - __popc(busy);
    if (n_free >= REFILL) {
      while (f.tail - f.head < n_free && f.has_lanes(p.B)) scan<F, ANY>(p, f, ring);
      __syncwarp();
      const int give = min(n_free, f.tail - f.head);
      if (give == 0 && !busy) break;
      const int rank = rank_in(~busy);
      if (r < 0 && rank < give) {
        r = ring[(f.head + rank) & (TRI_RING - 1)];
        ray.start(p, r);
      }
      f.head += give;
    }
    if (r < 0) continue;
    if constexpr (REFILL == 32) {
      // the warp's threads took their rays together: each sweeps its ray
      // to its answer, in lockstep while they test the same triangle
      while (!ray.step(s_tri, p.T)) {
      }
      ray.finish(p, r);
      r = -1;
    } else {
      for (int s = 0; s < ANY_STEPS; ++s) {
        if (ray.step(s_tri, p.T)) {
          ray.finish(p, r);
          r = -1;
          break;
        }
      }
    }
  }
}

template <typename F>
__global__ void __launch_bounds__(TRI_BLOCK) closest_tri(const TriParams<F> p) {
  tri_hits<F, false, CLOSEST_REFILL>(p);
}

template <typename F>
__global__ void __launch_bounds__(TRI_BLOCK) any_tri(const TriParams<F> p) {
  tri_hits<F, true, ANY_REFILL>(p);
}

template <typename F>
int closest_blocks() {
  static int cache[64];
  return resident_blocks(closest_tri<F>, TRI_BLOCK, cache, 64);
}

template <typename F>
int any_blocks() {
  static int cache[64];
  return resident_blocks(any_tri<F>, TRI_BLOCK, cache, 64);
}

template <typename F>
TriParams<F> tri_params(int B, int T, int grid, const void* tri, const void* const* rays,
                        const void* tmin, const void* tmax, unsigned long long* next) {
  TriParams<F> p{};
  p.B = B;
  p.T = T;
  const long long c = (long long)B / ((long long)TRI_CHUNKS * grid * (TRI_BLOCK / 32));
  p.chunk = (int)std::min(1024LL, std::max(32LL, c & ~31LL));
  p.tri = (const F*)tri;
  for (int k = 0; k < 3; ++k) {
    p.o[k] = (const F*)rays[k];
    p.d[k] = (const F*)rays[3 + k];
  }
  p.tmin = (const F*)tmin;
  p.tmax = (const F*)tmax;
  p.next = next;
  return p;
}

template <typename F>
void launch_closest(int B, int T, int grid, const void* tri, const void* const* rays,
                    const void* tmin, const void* tmax, void* t, int* tri_out,
                    void* u, void* v, unsigned long long* next, cudaStream_t stream) {
  TriParams<F> p = tri_params<F>(B, T, grid, tri, rays, tmin, tmax, next);
  p.t = (F*)t;
  p.tri_out = tri_out;
  p.u = (F*)u;
  p.v = (F*)v;
  closest_tri<F><<<grid, TRI_BLOCK, 0, stream>>>(p);
}

template <typename F>
void launch_any(int B, int T, int grid, const void* tri, const void* const* rays,
                const void* tmin, const void* tmax, unsigned char* hit,
                unsigned long long* next, cudaStream_t stream) {
  TriParams<F> p = tri_params<F>(B, T, grid, tri, rays, tmin, tmax, next);
  p.hit = hit;
  any_tri<F><<<grid, TRI_BLOCK, 0, stream>>>(p);
}

}  // namespace bpt

extern "C" {

// Launch on `stream` over `grid` persistent blocks (bpt_tri_blocks, at
// most); `next` is the launch's zeroed 64-bit work counter.  Each returns
// cudaGetLastError() after the launch (0 = launched); nothing is launched
// for B <= 0.  All pointers are device pointers to float64 data when
// f64 != 0, else float32; T is at most 256.
int bpt_closest_tri(int f64, int B, int T, int grid, const void* tri, const void* ox,
                    const void* oy, const void* oz, const void* dx,
                    const void* dy, const void* dz, const void* tmin,
                    const void* tmax, void* t, int* tri_out, void* u, void* v,
                    unsigned long long* next, void* stream) {
  const void* rays[6] = {ox, oy, oz, dx, dy, dz};
  if (B > 0) {
    if (f64) {
      bpt::launch_closest<double>(B, T, grid, tri, rays, tmin, tmax, t, tri_out, u, v,
                                  next, (cudaStream_t)stream);
    } else {
      bpt::launch_closest<float>(B, T, grid, tri, rays, tmin, tmax, t, tri_out, u, v,
                                 next, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

int bpt_any_tri(int f64, int B, int T, int grid, const void* tri, const void* ox,
                const void* oy, const void* oz, const void* dx, const void* dy,
                const void* dz, const void* tmin, const void* tmax,
                unsigned char* hit, unsigned long long* next, void* stream) {
  const void* rays[6] = {ox, oy, oz, dx, dy, dz};
  if (B > 0) {
    if (f64) {
      bpt::launch_any<double>(B, T, grid, tri, rays, tmin, tmax, hit, next,
                              (cudaStream_t)stream);
    } else {
      bpt::launch_any<float>(B, T, grid, tri, rays, tmin, tmax, hit, next,
                             (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

// closest_tri's (any = 0) or any_tri's persistent grid in float32 or
// float64: the blocks the current device holds at once, or a negative CUDA
// error code.
int bpt_tri_blocks(int f64, int any) {
  if (f64) return any ? bpt::any_blocks<double>() : bpt::closest_blocks<double>();
  return any ? bpt::any_blocks<float>() : bpt::closest_blocks<float>();
}

}  // extern "C"
