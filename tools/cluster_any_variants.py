"""Copies of this checkout's bpt_tpu_torch that each take out one design
element of the warp-wide clustered any hits (csrc/cluster_hit.cuh's
cluster_any, csrc/cluster_wave.cu's and csrc/plucker.cu's ``any``), for
tools/ab_cluster_kernels.py.

    python tools/cluster_any_variants.py DEST [NAME ...]

Writes DEST/NAME/{bpt_tpu_torch, chip_smoke.py} for each NAME given (all of
them by default) and prints the directories.  Each copy differs from the
checkout by the substitutions listed for it in VARIANTS; every copy
answers and counts as the checkout does, to the bit.  The substitutions
are verbatim passages of the sources as they stand (cluster_hit.cuh's
shared frame cluster_run, the providers' ``any``, the Plücker wrapper):
after an edit to one of those passages, pt_brute_variants.make stops and
names the passage that is missing, and VARIANTS must be brought up to
date before the tool makes copies again.  The elements:

- noA2: no compaction and no persistent grid: ceil(B / 128) blocks, each
  warp taking its own 32 lanes, dead ones too (a dead lane writes its
  false where the warp reads it);
- noA3: the Plücker any hit on the chop boxes alone (no groups), each
  slot's four rows of 10 coefficients of the [C, 128, 10] blocks in
  registers, summed over all 10 products, the ray read by shuffles;
- nogroups: the Plücker any hit without its group boxes (the 22
  coefficients kept);
- noA4roll, noA4pl: the rolled / Plücker any hit reading the entering ray
  (features) from its lane by shuffles, not from shared memory.

A NAME joined with "+" applies each part's substitutions, in order.  The
elements in the order they were added: A1 (warp-wide cluster tests) =
noA2+noA3+noA4roll, A1+A2 = noA3+noA4roll, A1+A2+A3 = noA4roll+noA4pl,
and the checkout.  For example:

    python tools/cluster_any_variants.py build/ab/v noA2+noA3+noA4roll noA3+noA4roll
    python tools/ab_cluster_kernels.py build/ab/parent build/ab/v/noA2+noA3+noA4roll \\
        build/ab/v/noA3+noA4roll . build/ab/parent
"""

from __future__ import annotations

import sys
from pathlib import Path

from pt_brute_variants import make

FRAME = "bpt_tpu_torch/csrc/cluster_hit.cuh"
ROLLED = "bpt_tpu_torch/csrc/cluster_wave.cu"
PLUCKER = "bpt_tpu_torch/csrc/plucker.cu"
WRAPPER = "bpt_tpu_torch/ops/kernels/plucker.py"
ANY_HEAD = """  __device__ static void any(const ClusterHitParams& p, ClusterLane& L, bool live,
                             float4 (*stage)[3]) {
    const int slot = threadIdx.x & 31;
"""
# the Plücker any hit of element A1: the chop boxes, the wide rows, shuffles
PLUCKER_A1 = ANY_HEAD + """    for (int k = 0; k < p.C; ++k) {
      const bool open = live && !L.done();
      if (!__ballot_sync(FULL_MASK, open)) break;
      const float* box = p.table + 6 * k;
      const bool in_k = open && L.enters<true>(box);
      unsigned mk = __ballot_sync(FULL_MASK, in_k);
      if (!mk) continue;
      const float px = L.ox - (__ldg(box) + __ldg(box + 3)) * 0.5f;
      const float py = L.oy - (__ldg(box + 1) + __ldg(box + 4)) * 0.5f;
      const float pz = L.oz - (__ldg(box + 2) + __ldg(box + 5)) * 0.5f;
      const float m0 = py * L.dz - pz * L.dy;
      const float m1 = pz * L.dx - px * L.dz;
      const float m2 = px * L.dy - py * L.dx;
      const int n = min(CLUSTER_TRIS, p.T - k * CLUSTER_TRIS);
      const float* blk = p.blocks + (size_t)k * 4 * CLUSTER_TRIS * NFEAT + NFEAT * slot;
      float a[4][NFEAT];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < NFEAT; ++j) a[e][j] = __ldg(blk + e * CLUSTER_TRIS * NFEAT + j);
      while (mk) {
        const int r = __ffs(mk) - 1;
        mk &= mk - 1;
        const float f[NFEAT] = {lane_of(L.dx, r), lane_of(L.dy, r), lane_of(L.dz, r),
                                lane_of(m0, r),   lane_of(m1, r),   lane_of(m2, r),
                                -lane_of(px, r),  -lane_of(py, r),  -lane_of(pz, r), 1.0f};
        const float tmin = lane_of(L.tmin, r), tmax = lane_of(L.tmax, r);
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = a[e][0] * f[0];
#pragma unroll
          for (int j = 1; j < NFEAT; ++j) sum = sum + a[e][j] * f[j];
          w[e] = sum;
        }
        const float w_ab = w[0], w_bc = w[1], w_ca = w[2], pn = w[3];
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

"""


def _plucker_any_body() -> str:
    """The checkout's PluckerChop::any, from its head to the closest hit's
    comment."""
    text = (Path(__file__).resolve().parents[1] / PLUCKER).read_text()
    start = text.index(ANY_HEAD)
    return text[start:text.index("  // The closest hit, warp-wide", start)]


VARIANTS = {
    "noA2": [
        (FRAME, """  const int slots = sched[0];
  const int warps = gridDim.x * (CLUSTER_BLOCK / 32);
  int k = 32;
  while (k > 1 && (k / 2) * warps >= slots) k /= 2;
""", """  const int slots = ANY ? p.B : sched[0];
  const int warps = gridDim.x * (CLUSTER_BLOCK / 32);
  int k = 32;
  while (!ANY && k > 1 && (k / 2) * warps >= slots) k /= 2;
"""),
        (FRAME, """    const int lane = l < k && j < slots ? sched[2 + j] : -1;
    const bool live = lane >= 0;
""", """    const int lane = ANY ? (j < slots && p.tmax[j] > 0.0f ? j : -1)
                         : (l < k && j < slots ? sched[2 + j] : -1);
    if (ANY && j < slots && lane < 0) p.hit[j] = 0;
    const bool live = lane >= 0;
"""),
        (FRAME, """      cluster_live<Provider, true><<<grid, CLUSTER_BLOCK, 0, s>>>(p, sched);
      cluster_any<Provider><<<blocks, CLUSTER_BLOCK, 0, s>>>(p, sched);
""", """      cluster_any<Provider><<<grid, CLUSTER_BLOCK, 0, s>>>(p, sched);
"""),
    ],
    "noA3": [
        (PLUCKER, _plucker_any_body(), PLUCKER_A1),
        (WRAPPER, "def _group_tables(scene: SceneTensors):",
         """def _chop_tables(scene: SceneTensors):
    tab = plucker_tables(scene)
    return 0, tab.n_clusters, tab.aabb, tab.blocks


def _group_tables(scene: SceneTensors):"""),
        (WRAPPER, """launch("plucker_any", "bpt_plucker_hit", _group_tables,""",
         """launch("plucker_any", "bpt_plucker_hit", _chop_tables,"""),
    ],
    "nogroups": [(PLUCKER, """      const bool in_g =
          open && box_entered(groups + 6 * g, L.ox, L.oy, L.oz, L.ix, L.iy, L.iz, L.tmax);
      if (!__ballot_sync(FULL_MASK, in_g)) continue;
""", """      const bool in_g = open;
""")],
    "noA4roll": [
        (ROLLED, ANY_HEAD + """    __syncwarp();
    if (live) {
      stage[slot][0] = make_float4(L.ox, L.oy, L.oz, L.dx);
      stage[slot][1] = make_float4(L.dy, L.dz, L.tmin, L.tmax);
    }
    __syncwarp();
""", ANY_HEAD),
        (ROLLED, """          const float4 r0 = stage[r][0], r1 = stage[r][1];
          const float ox = r0.x, oy = r0.y, oz = r0.z, dx = r0.w, dy = r1.x, dz = r1.y;
          const float tmin = r1.z, tmax = r1.w;
          bool valid;
""", """          const float ox = lane_of(L.ox, r), oy = lane_of(L.oy, r), oz = lane_of(L.oz, r);
          const float dx = lane_of(L.dx, r), dy = lane_of(L.dy, r), dz = lane_of(L.dz, r);
          const float tmin = lane_of(L.tmin, r), tmax = lane_of(L.tmax, r);
          bool valid;
"""),
    ],
    "noA4pl": [
        (PLUCKER, """        __syncwarp();
        if (in_k) {
          stage[slot][0] = make_float4(L.dx, L.dy, L.dz, m0);
          stage[slot][1] = make_float4(m1, m2, -px, -py);
          stage[slot][2] = make_float4(-pz, L.tmin, L.tmax, 0.0f);
        }
        __syncwarp();
""", ""),
        (PLUCKER, """          const float4 a0 = stage[r][0], a1 = stage[r][1], a2 = stage[r][2];
          const float f[NFEAT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, 1.0f};
          const float tmin = a2.y, tmax = a2.z;
""", """          const float f[NFEAT] = {lane_of(L.dx, r), lane_of(L.dy, r), lane_of(L.dz, r),
                                  lane_of(m0, r),   lane_of(m1, r),   lane_of(m2, r),
                                  -lane_of(px, r),  -lane_of(py, r),  -lane_of(pz, r), 1.0f};
          const float tmin = lane_of(L.tmin, r), tmax = lane_of(L.tmax, r);
"""),
    ],
}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for name in args[1:] or VARIANTS:
        print(make(Path(args[0]), name, VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
