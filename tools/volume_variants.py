"""Copies of a bpt_tpu_torch tree that each change one element of the
volume modes' free-flight override (csrc/volume.cuh), for
tools/ab_volume_kernels.py.

    python tools/volume_variants.py DEST NAME [NAME ...]

Writes DEST/NAME/{bpt_tpu_torch, chip_smoke.py} for each NAME, copied from
this checkout, and prints the directories.  Each copy differs from the
checkout by the substitutions listed for it in VARIANTS, verbatim passages
of the sources as they stand: after an edit to one of them, the tool stops
and names the passage that is missing.  The elements:

- E1: a box cull, measured and left out of the override: each volume's
  box and three scaled plane normals are packed after the media in volm
  (``pack_vol_boxes``, whose docstring states the rule), and a lane sweeps
  a volume only where its segment (T_MIN, t_hit) meets the box widened by
  a bound of Möller–Trumbore's float32 rounding on that lane, or where it
  grazes a boundary plane (``vol_box_open``); the same floats;
- noE2: the two probes as two sweeps (vol_closest from -inf, then from
  t1 + 1e-4f), as the first version did;
- split: the first version's override (two sweeps of every volume) with
  clock64 accumulators, on an E1 copy (``E1+split``): each lane adds the
  cycles it spends in the closest hits, the first and second probes, the
  draws, the whole override and (BDPT) the connections and their shadow
  sweeps, and its lifetime, into a per-thread array that
  ``bpt_vclk_take_pt`` / ``bpt_vclk_take_bdpt`` sum and zero; at each
  volume the first active lane of a warp counts whether any active lane
  needs the volume by E1's test (not acted on).  Its outputs equal the
  others' to the bit; its times are not comparable.

A NAME joined with "+" applies each part's substitutions, in order
(E1+noE2 is the first version's two sweeps behind the cull).

    python tools/volume_variants.py build/ab/v E1 E1+noE2 E1+split
    python tools/ab_volume_kernels.py build/ab/parent . build/ab/v/E1 \\
        build/ab/v/E1+noE2 build/ab/v/E1+split . build/ab/parent
"""

from __future__ import annotations

import sys
from pathlib import Path

from pt_brute_variants import make

VOLUME = "bpt_tpu_torch/csrc/volume.cuh"
SHADE = "bpt_tpu_torch/csrc/pt_shade.cuh"
PT = "bpt_tpu_torch/csrc/pt_megakernel.cu"
BDPT = "bpt_tpu_torch/csrc/bdpt_megakernel.cu"
WRAPPER = "bpt_tpu_torch/ops/kernels/pt_kernel.py"
CULL = "    if (!vol_box_open(s, v, ox, oy, oz, dx, dy, dz, ix, iy, iz, d_len, t_hit)) continue;\n"
PROBES = """    float t1, t2;
    vol_probes(s, v, ox, oy, oz, dx, dy, dz, t1, t2);
    if (!(t1 < inf)) continue;
"""
TWO_SWEEPS = """    const float t1 = vol_closest(s, v, ox, oy, oz, dx, dy, dz, -inf);
    if (!(t1 < inf)) continue;
    const float t2 = vol_closest(s, v, ox, oy, oz, dx, dy, dz, t1 + 1e-4f);
"""
# E1: the tables (Python) and the cull (CUDA)
KEEP_PY = "VOL_KEEP = 4  # the valid t's the override's one sweep keeps (csrc/volume.cuh)\n"
E1_CONSTS_PY = """VOLB_STRIDE = 16  # the cull's box: centre, half extents, slack, 3 normals
# The box cull's rule (pack_vol_boxes): a lane is culled only where s
# times the cosine between its direction and each boundary plane's normal
# is at least VOL_C_MIN, and its box is then widened by VOL_PAD_K * g / that
VOL_C_MIN = 2.0 ** -14
VOL_PAD_K = 2.0 ** -17
"""
CAMERA_PY = "def camera_table(cc: CameraConstants) -> torch.Tensor:"
E1_PACK_PY = r'''def _f32_up(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded up to a float32 value (kept in float64)."""
    y = x.to(torch.float32)
    return torch.where(y.double() < x, torch.nextafter(y, torch.tensor(math.inf)), y).double()


@per_scene
def pack_vol_boxes(scene: SceneTensors) -> torch.Tensor:
    """The free-flight override's box cull (``csrc/volume.cuh``), f32[MAX_VOLS*16]
    (zeros past the volumes): for each volume the centre c and half
    extents h of a box holding the vertices v0, v0 + e1, v0 + e2 of its
    boundary triangles as ``pack_vol_tables`` stores them (float32), then
    a slack delta and three normals s * n_k: n_k a unit normal of each
    plane orientation of its triangles, s the least of their shape
    factors |e1 x e2| / (|e1| |e2|).

    The rule.  Möller–Trumbore in float32 (no fused multiply-add) accepts
    a t whose point o + t d lies within 128 * 2^-24 * g / (s * cos) of the
    triangle, where g >= |o - v0| + the box's radius and cos = |d . n| /
    |d|: the rounding of each step's products and sums, set against |det|
    = |d| |e1 x e2| cos.  The bound holds where s * cos >= 2^-14, for
    there det's rounding is under 1% of it.  The kernel takes s * cos as
    min_k |d . s n_k| / |d| - delta (delta covers each triangle's distance
    from its n_k and the rounding of the stored normals and of the
    kernel's arithmetic).  Where that is at least VOL_C_MIN = 2^-14, it
    widens the box by pad = VOL_PAD_K * g / (s * cos), VOL_PAD_K = 2^-17,
    so every t the kernel accepts lies in the widened box's slab interval,
    and the cull, which tests that interval against (T_MIN, t_hit), skips
    only volumes whose two probes the override rejects.  A lane under
    VOL_C_MIN (it grazes a plane, where no small pad holds) is never
    culled, and neither is a volume with more than three plane
    orientations (delta = inf): such volumes are swept as before.
    tests/test_torch_volume_cull.py holds every accepted t inside the
    widened interval on corner, edge, face, grazing and box-plane lines."""
    vol, _ = pack_vol_tables(scene)
    rows = vol.reshape(MAX_VOL_TRIS, VOL_STRIDE).double().cpu()
    box = torch.zeros((MAX_VOLS, VOLB_STRIDE), dtype=torch.float64)
    for v in range(scene.num_volumes):
        r = rows[rows[:, 9] == v]
        v0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
        pts = torch.cat([v0, v0 + e1, v0 + e2])  # exact: sums of float32 values
        lo, hi = pts.amin(0), pts.amax(0)
        c = ((lo + hi) / 2).to(torch.float32).double()
        box[v, 0:3], box[v, 3:6] = c, _f32_up(torch.maximum(c - lo, hi - c))
        n = torch.linalg.cross(e1, e2)
        n_len = n.norm(dim=1)
        s = float((n_len / (e1.norm(dim=1) * e2.norm(dim=1))).amin())
        reps, far = [], 0.0  # unit normals, one an orientation; the farthest triangle
        for k in range(r.shape[0]):
            nk = n[k] / n_len[k]
            near = [float(torch.minimum((nk - q).norm(), (nk + q).norm())) for q in reps]
            if near and min(near) < 2.0 ** -10:
                far = max(far, min(near))
            else:
                reps.append(nk)
        if not (len(reps) <= 3 and s > 0 and math.isfinite(s)):
            box[v, 6] = math.inf
            continue
        q = [(s * nk).to(torch.float32).double() for nk in reps]
        delta = s * far + max(float((qk - s * nk).norm()) for qk, nk in zip(q, reps)) + 2.0 ** -20
        box[v, 6] = _f32_up(torch.tensor(delta, dtype=torch.float64))
        box[v, 7:16] = torch.cat((q * 3)[:3])
    return box.to(torch.float32).reshape(-1).to(scene.device)


@per_scene
def _vol_launch_tables(scene: SceneTensors):
    """(vol, volm) as the E1 kernels take them: ``pack_vol_tables``' vol,
    and its volm followed by ``pack_vol_boxes``."""
    vol, volm = pack_vol_tables(scene)
    return vol, torch.cat([volm, pack_vol_boxes(scene)])


'''
LAUNCH_PY = "    vol, volm = pack_vol_tables(scene)\n    return scene.num_volumes,"
KEEP_CU = "constexpr int VOL_KEEP = 4;      // the valid t's vol_probes keeps\n"
E1_CONSTS_CU = """constexpr int VOLB_STRIDE = 16;  // centre, half extents, slack, 3 normals
// pack_vol_boxes states the cull's rule: the least s * cosine a culled
// lane has to each boundary plane, and the pad's factor
constexpr float VOL_C_MIN = 0x1p-14f;
constexpr float VOL_PAD_K = 0x1p-17f;
"""
MED = "  float med[MAX_VOLS * VOLM_STRIDE];\n"
MED_STAGE = ("  for (int k = threadIdx.x; k < MAX_VOLS * VOLM_STRIDE; k += blockDim.x) "
             "s.med[k] = volm[k];\n")
BOX_STAGE = """  for (int k = threadIdx.x; k < MAX_VOLS * VOLB_STRIDE; k += blockDim.x)
    s.box[k] = volm[MAX_VOLS * VOLM_STRIDE + k];
"""
PROBES_HEAD = "// Both boundary probes of volume v"
E1_BOX_OPEN = r'''// Whether the override sweeps volume v on the line o + t d (ix, iy, iz:
// 1 / d; d_len: |d|) whose surface hit is at t_hit: where the lane's
// direction grazes one of the volume's boundary planes (s * cosine under
// VOL_C_MIN), always; else where the segment (T_MIN, t_hit) meets the
// volume's box widened by the pad that bounds Möller–Trumbore's rounding
// on this lane (pack_vol_boxes), by the BVH walk's slab test, a NaN term
// leaving its axis unconstrained.
__device__ __forceinline__ bool vol_box_open(const VolTables& s, int v, float ox, float oy,
                                             float oz, float dx, float dy, float dz,
                                             float ix, float iy, float iz, float d_len,
                                             float t_hit) {
  const float* b = &s.box[v * VOLB_STRIDE];
  const float m = fminf(fminf(fabsf(dx * b[7] + dy * b[8] + dz * b[9]),
                              fabsf(dx * b[10] + dy * b[11] + dz * b[12])),
                        fabsf(dx * b[13] + dy * b[14] + dz * b[15]));
  const float cosine = m / d_len - b[6];
  if (!(cosine >= VOL_C_MIN)) return true;
  const float cx = b[0] - ox, cy = b[1] - oy, cz = b[2] - oz;
  const float g = (fabsf(cx) + fabsf(cy) + fabsf(cz)) + (b[3] + b[4] + b[5]);
  const float pad = VOL_PAD_K * g / cosine;
  float lox, hix, loy, hiy, loz, hiz;
  const float wx = b[3] + pad, wy = b[4] + pad, wz = b[5] + pad;
  slab_axis(cx - wx, cx + wx, 0.0f, ix, lox, hix);
  slab_axis(cy - wy, cy + wy, 0.0f, iy, loy, hiy);
  slab_axis(cz - wz, cz + wz, 0.0f, iz, loz, hiz);
  const float enter = fmaxf(fmaxf(lox, loy), fmaxf(loz, T_MIN));
  const float exit_ = fminf(fminf(hix, hiy), fminf(hiz, t_hit));
  return exit_ > enter;
}

'''
INCLUDE = '#include "common.cuh"\n'
FF_HEAD = """  const float inf = __int_as_float(0x7f800000);
  bool vhit = false;
  for (int v = 0; v < s.n; ++v) {
"""
FF_HEAD_E1 = """  const float inf = __int_as_float(0x7f800000);
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  bool vhit = false;
  for (int v = 0; v < s.n; ++v) {
""" + CULL
FREE_FLIGHT = """  bool vhit = false;
  for (int v = 0; v < s.n; ++v) {
""" + CULL + PROBES + """    float tt1 = fmaxf(t1, T_MIN);
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
"""
# the first version's override, timed, with the cull's warp census
FREE_FLIGHT_SPLIT = """  const long long f0 = clock64();
  unsigned long long a2 = 0, a3 = 0, a4 = 0, n12 = 0, n13 = 0, n14 = 0;
  bool vhit = false;
  for (int v = 0; v < s.n; ++v) {
    const bool open = vol_box_open(s, v, ox, oy, oz, dx, dy, dz, ix, iy, iz, d_len, t_hit);
    const unsigned m = __activemask();
    const unsigned b = __ballot_sync(m, open);
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
      vclk_add(8, 1);
      vclk_add(9, b == 0u);
      vclk_add(10, __popc(m));
      vclk_add(11, __popc(b));
    }
    const long long c1 = clock64();
    const float t1 = vol_closest(s, v, ox, oy, oz, dx, dy, dz, -inf);
    const long long c2 = clock64();
    a2 += c2 - c1;
    n12 += 1;
    if (!(t1 < inf)) continue;
    const float t2 = vol_closest(s, v, ox, oy, oz, dx, dy, dz, t1 + 1e-4f);
    a3 += clock64() - c2;
    n13 += 1;
    float tt1 = fmaxf(t1, T_MIN);
    const float tt2 = fminf(t2, t_hit);
    if (!(t2 < inf && tt1 < tt2)) continue;
    const long long c4 = clock64();
    tt1 = fmaxf(tt1, 0.0f);
    const float dist_inside = (tt2 - tt1) * d_len;
    const float hd = s.med[v * VOLM_STRIDE] * logf(fmaxf(draw(v), 1e-37f));
    a4 += clock64() - c4;
    n14 += 1;
    if (!(hd <= dist_inside)) continue;
    t_hit = tt1 + hd / d_len;
    vmat = (int)s.med[v * VOLM_STRIDE + 1];
    vhit = true;
  }
  const long long f1 = clock64();
  vclk_add(2, a2);
  vclk_add(3, a3);
  vclk_add(4, a4);
  vclk_add(5, f1 - f0);
  vclk_add(12, n12);
  vclk_add(13, n13);
  vclk_add(14, n14);
  vclk_add(15, 1);
  return vhit;
"""
VCLK = """constexpr int MAX_VOLS = 4;
"""
VCLK_SPLIT = """constexpr int MAX_VOLS = 4;
// tools/volume_variants.py split: a thread's cycle and event accumulators
constexpr int VCLK_SLOTS = 16;
constexpr int VCLK_THREADS = 1 << 18;
static __device__ unsigned long long g_vclk[VCLK_THREADS * VCLK_SLOTS];
__device__ __forceinline__ void vclk_add(int slot, unsigned long long x) {
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < VCLK_THREADS) g_vclk[(size_t)tid * VCLK_SLOTS + slot] += x;
}
"""



def _take(name: str) -> str:
    """The extern "C" reader of one source's accumulators."""
    return f"""int bpt_vclk_take_{name}(unsigned long long* out) {{
  static unsigned long long host[bpt::VCLK_THREADS * bpt::VCLK_SLOTS];
  cudaError_t e = cudaMemcpyFromSymbol(host, bpt::g_vclk, sizeof(host));
  if (e != cudaSuccess) return (int)e;
  for (int k = 0; k < bpt::VCLK_SLOTS; ++k) out[k] = 0;
  for (size_t t = 0; t < (size_t)bpt::VCLK_THREADS; ++t)
    for (int k = 0; k < bpt::VCLK_SLOTS; ++k) out[k] += host[t * bpt::VCLK_SLOTS + k];
  void* addr = nullptr;
  e = cudaGetSymbolAddress(&addr, bpt::g_vclk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(addr, 0, sizeof(host));
}}

"""


PT_HIT = "  const Hit h = closest(cox, coy, coz, cdx, cdy, cdz);\n"
BDPT_HIT = "    const Hit h = hits(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);\n"
PT_LANES = """  const long long n = (long long)p.B * p.nk;
  int item = -1;  // the lane's work item; -1 when the lane is free
"""
PT_LANES_END = """    item = -1;
  }
}
"""
BDPT_SAMPLES = """  const int n = p.B * p.nk;
  for (;;) {
    const int base = warp_take(p.next);
"""
BDPT_SAMPLES_END = """    p.out_b[o] = rid >= 0 ? sub.b + summed.cb : 0.0f;
  }
}
"""
SHADOW = "    if (hits.occluded(ox, oy, oz, dx, dy, dz, tmax)) return false;\n"
CONNECT = "        connect(s, p, cam, lgt, sub.n_cam, sub.n_light, summed, vis);\n"
VARIANTS = {
    "E1": [
        (WRAPPER, "import functools\n", "import functools\nimport math\n"),
        (WRAPPER, KEEP_PY, KEEP_PY + E1_CONSTS_PY),
        (WRAPPER, CAMERA_PY, E1_PACK_PY + CAMERA_PY),
        (WRAPPER, LAUNCH_PY, LAUNCH_PY.replace("pack_vol_tables", "_vol_launch_tables")),
        (VOLUME, INCLUDE, '#include "bvh_walk.cuh"\n' + INCLUDE),
        (VOLUME, KEEP_CU, KEEP_CU + E1_CONSTS_CU),
        (VOLUME, MED, MED + "  float box[MAX_VOLS * VOLB_STRIDE];\n"),
        (VOLUME, MED_STAGE, MED_STAGE + BOX_STAGE),
        (VOLUME, PROBES_HEAD, E1_BOX_OPEN + PROBES_HEAD),
        (VOLUME, FF_HEAD, FF_HEAD_E1),
    ],
    "noE2": [(VOLUME, PROBES, TWO_SWEEPS)],
    "split": [
        (VOLUME, VCLK, VCLK_SPLIT),
        (VOLUME, FREE_FLIGHT, FREE_FLIGHT_SPLIT),
        (SHADE, PT_HIT, "  const long long ch0 = clock64();\n" + PT_HIT
         + "  vclk_add(1, clock64() - ch0);\n"),
        (PT, PT_LANES, "  const long long lt0 = clock64();\n" + PT_LANES),
        (PT, PT_LANES_END, PT_LANES_END[:-2] + "  vclk_add(0, clock64() - lt0);\n}\n"),
        (PT, "const char* bpt_cuda_error_string(int code) {",
         _take("pt") + "const char* bpt_cuda_error_string(int code) {"),
        (BDPT, BDPT_HIT, "    const long long ch0 = clock64();\n" + BDPT_HIT
         + "    vclk_add(1, clock64() - ch0);\n"),
        (BDPT, BDPT_SAMPLES, "  const long long lt0 = clock64();\n" + BDPT_SAMPLES),
        (BDPT, BDPT_SAMPLES_END, BDPT_SAMPLES_END[:-2] + "  vclk_add(0, clock64() - lt0);\n}\n"),
        (BDPT, SHADOW, "    const long long sh0 = clock64();\n"
         "    const bool occ = hits.occluded(ox, oy, oz, dx, dy, dz, tmax);\n"
         "    vclk_add(7, clock64() - sh0);\n    if (occ) return false;\n"),
        (BDPT, CONNECT, "        const long long cn0 = clock64();\n" + CONNECT
         + "        vclk_add(6, clock64() - cn0);\n"),
        (BDPT, "int bpt_bdpt_blocks(int walk, int vols) {",
         _take("bdpt") + "int bpt_bdpt_blocks(int walk, int vols) {"),
    ],
}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for name in args[1:]:
        print(make(Path(args[0]), name, VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
