// Persistent scheduling of the walk-mode megakernels (pt_megakernel_walk,
// bdpt_megakernel_walk) and of the brute-force BDPT megakernel
// (bdpt_megakernel): one lane per sample, as many blocks as the card holds
// at once, each warp taking its next 32 samples from a counter.  The wave
// kernels closest_bvh and any_bvh (pt_wave.cu) and the brute-force PT
// megakernel (pt_megakernel) run on such a grid too, their warps taking
// rays or samples for their free lanes (warp_take_n).
//
// Why.  A walk-mode sample is a chain of BVH walks whose node loads depend
// on each other, and its length depends on the path (a sample through the
// coffee stand-in's glass can run to depth 80 while its neighbours end
// after two bounces).  A thread per pixel that walks its strata one after
// another launches fewer threads than the card holds at 256^2 pixels, and a
// warp then waits for its deepest pixel's whole run of strata.  A thread per
// sample with a shared work counter keeps every block slot busy and holds a
// warp for one sample's chain at a time.
//
// The work items of a launch: rays mode, one a ray; pixels mode, one a
// (pixel lane, stratum) pair of the launch's stratum range [k0, k0 + nk),
// numbered lane * nk + (k - k0), so that a warp takes consecutive strata of
// neighbouring pixels.  A sample's draws stay keyed by its absolute id
// pix * spp + k, so the schedule changes no bit of it; each sample's
// radiance goes to row k - k0 of a stratum-major [nk][B] output, which the
// wrapper adds into the pixel totals in stratum order.
#pragma once

#include <cuda_runtime.h>

namespace bpt {

// The first of the warp's next 32 work items: lane 0 takes them from the
// launch's counter (zeroed by the wrapper), the other lanes read its base.
// Every lane of the warp calls it, so the loop around it stays converged.
__device__ __forceinline__ int warp_take(int* next) {
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(next, 32);
  return __shfl_sync(0xffffffffu, base, 0);
}

// The first of n consecutive work items for the warp's free lanes (the
// wave kernels' refill, pt_wave.cu): lane 0 takes them from the launch's
// 64-bit counter (zeroed by the wrapper) with one atomic, every lane reads
// the base.  Called by every lane of the warp, after a __syncwarp.
__device__ __forceinline__ long long warp_take_n(unsigned long long* next, int n) {
  unsigned long long base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(next, (unsigned long long)n);
  return (long long)__shfl_sync(0xffffffffu, base, 0);
}

// The number of lanes of `mask` below this one: a free lane's rank among
// the warp's free lanes, and so its offset from warp_take_n's base.
__device__ __forceinline__ int rank_in(unsigned mask) {
  return __popc(mask & ((1u << (threadIdx.x & 31)) - 1u));
}

// Sum of v over the warp, in every lane.
__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the lanes below this one.
__device__ __forceinline__ int warp_exclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  return incl - v;
}

// Blocks of `kernel` (block threads, no dynamic shared memory) that the
// current device holds at once: cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// at most max_per_sm where that is given (> 0), times the SM count, queried
// once a process and device (cache[device], 0 = not yet).  Returns a
// negative CUDA error code on failure.
template <class Kernel>
int resident_blocks(Kernel kernel, int block, int* cache, int n_cache, int max_per_sm = 0) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < n_cache && cache[dev] > 0) return cache[dev];
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
  const int blocks = per_sm * sms;
  if (blocks < 1) return -(int)cudaErrorInvalidConfiguration;
  if (dev < n_cache) cache[dev] = blocks;
  return blocks;
}

}  // namespace bpt
