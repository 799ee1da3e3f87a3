// The in-order sum of a pixels-mode launch's per-sample radiance for
// Hopper (sm_90a).
//
// The persistent megakernels (pt_megakernel.cu in both modes, the BDPT
// megakernel in both) write each sample's radiance on its own, stratum
// by stratum, into a stratum-major [3][nk][B] buffer; this kernel adds a
// launch's rows into the pixel totals [3][B] one stratum after another,
// ((tot + s0) + s1) + ..., from 0 on a call's first range.  That is the
// float-add sequence of a lane that sums its strata in order, the flush of
// bpt_tpu's persistent-sample lanes into the pixel total
// (bpt_tpu/ops/pallas/pt_kernel.py:898, inside pt_megakernel_pixels), so
// no launch split changes a bit.  It replaces nk elementwise torch adds,
// each a launch of its own (ops/kernels/pt_kernel.py::strata_sum_plain).
//
// What bounds it on the H100: bytes.  A thread a (channel, lane) reads
// its nk samples, neighbouring threads neighbouring lanes (coalesced), and
// writes one total: 12 * nk * B bytes in, 12 * B out.
#include <cuda_runtime.h>

namespace bpt {

constexpr int SUM_BLOCK = 256;

__global__ void __launch_bounds__(SUM_BLOCK) strata_sum(int B, int nk, int first,
                                                        const float* __restrict__ rows,
                                                        float* __restrict__ tot) {
  const long long i = (long long)blockIdx.x * SUM_BLOCK + threadIdx.x;
  if (i >= 3LL * B) return;
  const long long c = i / B;
  const float* r = rows + c * nk * B + (i - c * B);
  float t = first ? 0.0f : tot[i];
  for (int k = 0; k < nk; ++k) t = t + r[(long long)k * B];
  tot[i] = t;
}

}  // namespace bpt

extern "C" {

// Adds rows [3][nk][B] into tot [3][B] (from 0 when first != 0) on
// `stream`; returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.  Device
// pointers.
int bpt_strata_sum(int first, int B, int nk, const float* rows, float* tot, void* stream) {
  if (B < 0 || nk < 1 || (long long)B * nk > (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int blocks = (int)((3LL * B + bpt::SUM_BLOCK - 1) / bpt::SUM_BLOCK);
    bpt::strata_sum<<<blocks, bpt::SUM_BLOCK, 0, (cudaStream_t)stream>>>(B, nk, first, rows, tot);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
