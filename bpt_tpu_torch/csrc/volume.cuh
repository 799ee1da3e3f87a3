// The free-flight override of constant-density volumes that the PT
// megakernel (pt_megakernel.cu), the PT wave's shade (pt_wave.cu) and the
// BDPT megakernel (bdpt_megakernel.cu) run after each closest hit: the
// counterpart of _vol_closest_smem and the override block of
// bpt_tpu/ops/pallas/pt_kernel.py:125-166, 359-395 (the same block is
// bdpt_kernel.py:377-416), constant_medium::hit (constant_medium.h:24-56)
// for every volume in order, as if the volumes came last in the hittable
// list.
//
// What it computes is the Pallas kernel's: a volume's boundary hits with
// strict bounds (t > lo_t, t < t_best), the draw logf(fmaxf(u, 1e-37f)) in
// IEEE logf (never __logf), and t_cur shrinking across the volumes.  The
// plain version (ops/soa.py::volume_interaction, bpt_tpu's jnp path) takes
// t in the closed interval and logs u unclamped; the two differ only on
// exact t ties and at u < 1e-37.
//
// Design: the tables (at most 64 boundary triangles, 4 volumes: 2.6 KB)
// sit in shared memory beside the shading tables, and each volume sweeps
// only the span of its own triangles, [first, end), which staging finds
// from the owner column (the builder emits a volume's triangles together,
// so the span is the volume's own rows; the owner test inside the span
// keeps any other order right).  The Pallas kernel sweeps all VT rows
// under an owner mask: the same minimum for half the tests on the
// two-volume cornell_smoke.  A lane whose first probe misses skips its
// draw; boundary tests add to no counter.
// - Both probes in one sweep (vol_probes): the first version swept a
//   volume's span again from t1 + 1e-4 wherever the first probe hit.  The
//   sweep now keeps the VOL_KEEP smallest valid t's, sorted; t1 is the
//   first and t2 the first above t1 + 1e-4f, by vol_closest's strict
//   comparisons, so the same floats.  Only where none of the kept is and
//   the sweep dropped one does a second sweep run (PERF.md §6, rows 2v
//   and 6v).
// - Culling a volume by a box around it (a lane skips the sweep where
//   its segment misses the box, widened by a bound of Möller–Trumbore's
//   rounding) skips most lanes' sweeps on cornell_smoke but few warps',
//   and its own test costs more than it saves: measured and left out
//   (tools/volume_variants.py E1, PERF.md §6).
#pragma once

#include "common.cuh"

namespace bpt {

constexpr int MAX_VOLS = 4;
constexpr int MAX_VOL_TRIS = 64;
constexpr int VOL_STRIDE = 10;   // v0(3) e1(3) e2(3) owning volume
constexpr int VOLM_STRIDE = 2;   // -1/density, phase material id
constexpr int VOL_KEEP = 4;      // the valid t's vol_probes keeps

// The volume tables a block stages in shared memory
// (ops/kernels/pt_kernel.py::pack_vol_tables) and each volume's span.
struct VolTables {
  float tri[MAX_VOL_TRIS * VOL_STRIDE];
  float med[MAX_VOLS * VOLM_STRIDE];
  int first[MAX_VOLS], end[MAX_VOLS];
  int n;  // volumes
};

// Stages the tables of V volumes over VT boundary triangles (device
// pointers vol, volm); the caller's __syncthreads() publishes them.
__device__ __forceinline__ void stage_volumes(const float* vol, const float* volm, int V,
                                              int VT, VolTables& s) {
  for (int k = threadIdx.x; k < VT * VOL_STRIDE; k += blockDim.x) s.tri[k] = vol[k];
  for (int k = threadIdx.x; k < MAX_VOLS * VOLM_STRIDE; k += blockDim.x) s.med[k] = volm[k];
  if (threadIdx.x < MAX_VOLS) {
    const float v = (float)threadIdx.x;
    int first = VT, end = 0;
    for (int k = 0; k < VT; ++k) {
      if (vol[k * VOL_STRIDE + 9] == v) {
        first = min(first, k);
        end = k + 1;
      }
    }
    s.first[threadIdx.x] = first;
    s.end[threadIdx.x] = max(first, end);
  }
  if (threadIdx.x == 0) s.n = V;
}

// The closest boundary hit of volume v with lo_t < t (inf if none).
__device__ __forceinline__ float vol_closest(const VolTables& s, int v, float ox, float oy,
                                             float oz, float dx, float dy, float dz,
                                             float lo_t) {
  const float owner = (float)v;
  float t_best = __int_as_float(0x7f800000);
  for (int k = s.first[v]; k < s.end[v]; ++k) {
    const float* tr = &s.tri[k * VOL_STRIDE];
    if (tr[9] != owner) continue;
    bool valid;
    const float t = moller_trumbore(ox, oy, oz, dx, dy, dz, tr, valid);
    if (valid && t > lo_t && t < t_best) t_best = t;
  }
  return t_best;
}

// Both boundary probes of volume v in one sweep: t1 = vol_closest from
// -inf and t2 = vol_closest from t1 + 1e-4f, as the same floats.  The
// sweep keeps the VOL_KEEP smallest valid t's in k[], sorted (a t equal to
// the last kept one is dropped: the same value); t2 is the first kept t
// above t1 + 1e-4f.  Where none is and a valid t was dropped, t2 comes
// from a second sweep.
__device__ __forceinline__ void vol_probes(const VolTables& s, int v, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float& t1,
                                           float& t2) {
  const float owner = (float)v;
  const float inf = __int_as_float(0x7f800000);
  float k[VOL_KEEP];
#pragma unroll
  for (int i = 0; i < VOL_KEEP; ++i) k[i] = inf;
  bool dropped = false;
  for (int j = s.first[v]; j < s.end[v]; ++j) {
    const float* tr = &s.tri[j * VOL_STRIDE];
    if (tr[9] != owner) continue;
    bool valid;
    float t = moller_trumbore(ox, oy, oz, dx, dy, dz, tr, valid);
    if (valid && t > -inf && t < inf) {
#pragma unroll
      for (int i = 0; i < VOL_KEEP; ++i) {
        const float lo = fminf(k[i], t);
        t = fmaxf(k[i], t);
        k[i] = lo;
      }
      dropped = dropped || t < inf;
    }
  }
  t1 = k[0];
  const float lo_t = t1 + 1e-4f;
  t2 = inf;
#pragma unroll
  for (int i = VOL_KEEP - 1; i > 0; --i) t2 = k[i] > lo_t ? k[i] : t2;
  if (dropped && !(t2 < inf)) t2 = vol_closest(s, v, ox, oy, oz, dx, dy, dz, lo_t);
}

// The override for one live ray (o, d) whose closest surface hit is at
// t_hit (inf on a miss).  draw(v) gives volume v's free-flight uniform.
// Returns true if the ray scatters in a volume first; then t_hit is the
// scatter distance and vmat the phase material.
template <class Draw>
__device__ __forceinline__ bool free_flight(const VolTables& s, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float& t_hit,
                                            int& vmat, const Draw& draw) {
  const float d_len = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inf = __int_as_float(0x7f800000);
  bool vhit = false;
  for (int v = 0; v < s.n; ++v) {
    float t1, t2;
    vol_probes(s, v, ox, oy, oz, dx, dy, dz, t1, t2);
    if (!(t1 < inf)) continue;
    float tt1 = fmaxf(t1, T_MIN);
    const float tt2 = fminf(t2, t_hit);
    if (!(t2 < inf && tt1 < tt2)) continue;
    tt1 = fmaxf(tt1, 0.0f);
    const float dist_inside = (tt2 - tt1) * d_len;
    const float hd = s.med[v * VOLM_STRIDE] * logf(fmaxf(draw(v), 1e-37f));
    if (!(hd <= dist_inside)) continue;
    t_hit = tt1 + hd / d_len;
    vmat = (int)s.med[v * VOLM_STRIDE + 1];
    vhit = true;
  }
  return vhit;
}

}  // namespace bpt
