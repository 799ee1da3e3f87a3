// Fused BDPT megakernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of bpt_tpu/ops/pallas/bdpt_kernel.py
// (_bdpt_kernel_impl, launched by bdpt_megakernel and
// bdpt_megakernel_pixels).  Per lane: the camera subpath with background,
// per-vertex emission, the light subpath from an area-sampled emitter, and
// every (s, t) connection with a shadow any-hit, summed unweighted (bdpt,
// the reference's estimator) or with power-heuristic MIS weights
// (bdpt-mis); in pixels mode also raygen and every spp stratum.
// Untextured float32 scenes with 16 materials and 16 lights, and at most 4
// constant-density volumes over 64 boundary triangles, any depth from 1 to
// MAX_DEPTH = 80.  Two modes, as the Pallas kernel has
// (use_clusters): a scene of at most 512 triangles sweeps them all, brute
// force, from shared memory (bdpt_megakernel); a larger one walks its BVH
// for the closest hits and the shadow rays (bdpt_megakernel_walk, the
// counterpart of the clustered mode's make_clustered_closest and
// make_rolled_any_hit, bdpt_kernel.py:169-186 and clusters.py:876, 901).
//
// What bounds it on the H100.  Brute mode: FP32 throughput in the
// triangle sweeps (one per traced bounce and one per connection candidate,
// so up to depth^2 shadow sweeps per sample; at depth 10 on the cornell
// box two in three sweeps are shadow sweeps) and warp divergence (subpath
// lengths and connection candidates differ per lane).  Walk mode: the
// walks' dependent node loads (pt_wave.cu), up to depth^2 shadow walks per
// sample, and how unevenly they fall on the lanes: one deep sample holds
// its warp.  The one other memory stream is the vertex records.
//
// Design: real branches instead of masked selects, the material / light
// tables and the slot keys (and in brute mode the triangle table) in
// shared memory as in pt_megakernel.cu; the walk reads the BVH from global
// memory, so the mode has no table budget.  Both modes run one body
// (samples, below): one lane per sample on a persistent grid
// (walk_sched.cuh), so a warp waits for one sample's chain at a time and
// not for a pixel's run of strata.  The walk mode shares each warp's shadow
// walks across its 32 lanes (Ring), so a deep sample's connections do not
// run on one lane while 31 wait; the brute mode sweeps each shadow ray
// where it comes up, since sharing a 24-triangle sweep cost more in extra
// passes over the connections than it saved (PERF.md §6).  Vertex
// records (14 floats; 17 with MIS) live in a scratch in device memory,
// [threads][2][depth][stride], allocated by the wrapper: a resident
// thread's, its records contiguous.  The lanes of a warp read records of
// different slots in the connection loop, so a field of a record falls in
// the sectors of the record's other fields, not of 31 other lanes' records
// (a field-major layout, coalesced where lanes agree on the slot, ran
// 9-13% slower: PERF.md §6).  Its bound is 2 * depth * stride * 4 B
// a thread: 1,360 B at depth 10 with MIS, 10,880 B at depth 80 (735 MB for
// the walk mode's 67,584 resident threads on an H100).  Every loop over
// vertices is bounded by the sample's own subpath lengths (slots fill
// prefix-first), so a sample never reads a slot its thread left from an
// earlier sample.
// With MIS a vertex keeps the suffix sum of its own side down to slot 0
// (V_SUF): a connection whose strategies the realizability clamp does not
// cut reads it instead of scanning its side again.
// The TPU kernel's tile-wide gates, tile-max loop bounds, lock-step while
// loop and VMEM row clamp have no counterpart: per-lane bounds give the
// same sums.  Draws are word x0 of
// threefry2x32 keyed per (section, bounce, slot) at counter (sample id, 0).
// Arithmetic follows the plain PyTorch version's operation order
// (models/bdpt.py), so that with -fmad=false every branch decision agrees
// with it; the previous vertex of the first light-traced vertex is the
// emitter point, as there.  Counters are exact 64-bit integers: rays and
// visible connections, then the provider's node visits, box hits,
// triangle tests and accepted tests (bvh_walk.cuh; shadow rays add to all
// but the last).
//
// Volumes: a scene with constant-density volumes launches the _vol
// kernels, the same bodies instantiated with VOLS: they stage the volume
// tables in shared memory and run volume.cuh's free-flight override after
// each closest hit of a trace (bdpt_kernel.py:377-416), before its miss
// test; a trace bounce then has NT + V slots, the V free-flight draws
// last, and the key table grows to match.  The triangle-hit counter
// counts surface hits before the override, and boundary tests count
// nowhere; shadow rays do not see volumes, as in bpt_tpu.  The kernels of
// a scene without volumes are the bodies without VOLS, compiled as before.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "common.cuh"
#include "volume.cuh"
#include "walk_sched.cuh"

namespace bpt {
namespace bdpt {

constexpr int MAX_TRIS = 512;
constexpr int MAX_MATS = 16;
constexpr int MAX_LIGHTS = 16;
constexpr int MAT_STRIDE = 6;   // mtype, albedo(3), fuzz, ior
constexpr int LGT_STRIDE = 13;  // v0(3) e1(3) e2(3) n(3) area(1)
// light-table tail: background(3), total area, per-light material ids
constexpr int LGT_TAIL = MAX_LIGHTS * LGT_STRIDE;
constexpr int LGT_WORDS = LGT_TAIL + 4 + MAX_LIGHTS;
constexpr int NT = 5;   // trace slots per bounce (models.bdpt TU_*)
constexpr int NLS = 5;  // light-start slots (models.bdpt LS_*)
constexpr int MAX_DEPTH = 80;
constexpr int MAX_SLOTS = MAX_DEPTH * NT + NLS + (MAX_DEPTH - 1) * NT;
constexpr int MAX_KEYS = 2 * MAX_SLOTS + 4;
constexpr int MAX_SLOTS_VOL =
    MAX_DEPTH * (NT + MAX_VOLS) + NLS + (MAX_DEPTH - 1) * (NT + MAX_VOLS);
constexpr int MAX_KEYS_VOL = 2 * MAX_SLOTS_VOL + 4;
constexpr int BLOCK = 128;

enum { TU_B1 = 0, TU_B2 = 1, TU_DIEL = 2, TU_FZ1 = 3, TU_FZ2 = 4 };
enum { LS_PICK = 0, LS_U = 1, LS_V = 2, LS_D1 = 3, LS_D2 = 4 };
enum { M_LAM = 0, M_METAL = 1, M_DIEL = 2, M_LIGHT = 3, M_ISO = 4 };
// vertex record fields (bdpt_kernel.py store_vtx; pfwd, rat2 and the
// suffix sum to slot 0 with MIS)
enum { V_PX = 0, V_PY, V_PZ, V_NX, V_NY, V_NZ, V_TR, V_TG, V_TB,
       V_ER, V_EG, V_EB, V_MAT, V_FLAGS, V_PFWD, V_RAT2, V_SUF };
constexpr int VTX_STRIDE = 14, VTX_STRIDE_MIS = 17;
enum { F_VALID = 1, F_DELTA = 2, F_LIGHT = 4, F_MISCUT = 8 };

constexpr float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
// max_t * (1 - SHADOW_EPS_REL): the connection's endpoint margin
constexpr float SHADOW_SCALE = (float)(1.0 - 1e-4);

struct Params {
  int pixels;  // 0: rays given (o, d); 1: in-kernel raygen + spp loop
  int mis;
  int B, T, L, depth, sqrt_spp, nkeys;
  const float* tri;      // brute mode: [MAX_TRIS * 13]
  Bvh g;                 // walk mode: the BVH (g.N > 0)
  const int* mat_id;     // walk mode: [T]
  const float* mat;      // [MAX_MATS * 6]
  const float* lgt;      // [LGT_WORDS]
  const uint32_t* keys;  // [2 * n_slots] (+4 jitter words in pixels mode)
  const float* cam;      // [13] pixel00, du, dv, center, 1/sqrt_spp
  // rays mode: ox, oy, oz, dx, dy, dz; pixels mode: i, j
  const float* in[6];
  const int* rid;     // [B] ray / pixel id; < 0 = inactive lane
  const float* ubuf;  // optional [n_slots, B] injected uniforms
  // vertex scratch [the grid's threads][2][depth][stride], a resident
  // thread's
  float* vtx;
  int k0, nk;  // pixels mode: the launch's strata [k0, k0 + nk); rays mode 0, 1
  int* next;   // the work counter (walk_sched.cuh)
  // [nk][B]: sample (lane, k) at (k - k0) * B + lane
  float* out_r;
  float* out_g;
  float* out_b;
  // [6] rays, shadow rays, node visits, box hits, tri tests, tri hits
  unsigned long long* counters;
  int V, VT;          // volumes and their boundary triangles
  const float* vol;   // [MAX_VOL_TRIS * 10] (pack_vol_tables)
  const float* volm;  // [MAX_VOLS * 2]
};

// The shading tables and slot keys every block stages in shared memory.
template <int NK>
struct TablesOf {
  float mat[MAX_MATS * MAT_STRIDE];
  float lgt[LGT_WORDS];
  uint32_t keys[NK];
};
using Tables = TablesOf<MAX_KEYS>;
using TablesVol = TablesOf<MAX_KEYS_VOL>;

// The brute mode's shared memory: the triangle table ahead of the shading
// tables in one struct.  Kept as one struct: with the triangle table in
// an array of its own the kernel ran 5-6% slower (PERF.md, Findings).
template <class Tab>
struct BruteTablesOf {
  float tri[MAX_TRIS * TRI_STRIDE];
  Tab shade;
};

// Slots a trace bounce draws: NT, and a volume scene's V free-flight slots.
template <bool VOLS>
__device__ __forceinline__ int trace_slots(const Params& p) {
  return VOLS ? NT + p.V : NT;
}

// A lane's counters: traced rays and visible connections, and the hit
// provider's node visits, box hits, triangle tests and accepted tests,
// which it adds to the base (bvh_walk.cuh).
struct Counts : TraceCounts {
  unsigned long long rays = 0, shadow = 0;
};

// A lane's draws: the injected buffer when given, else word x0 of
// threefry(key of the slot, (sample id, 0)).
struct Stream {
  const float* ubuf;
  int B;
  int lane;
  const uint32_t* keys;
  uint32_t ridu;

  __device__ __forceinline__ float draw(int slot) const {
    if (ubuf) return ubuf[(size_t)slot * B + lane];
    uint32_t x0 = ridu, x1 = 0u;
    threefry2x32(keys[2 * slot], keys[2 * slot + 1], x0, x1);
    return bits_to_unit(x0);
  }
};

// One side's vertex records of one thread: `stride` floats a slot,
// contiguous.
struct Verts {
  float* base;
  int stride;

  __device__ __forceinline__ float& at(int slot, int field) const {
    return base[slot * stride + field];
  }
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The vertex before the next one traced (models.bdpt mis_prev).
struct Prev {
  float px, py, pz, nx, ny, nz;
  bool delta;
  int mtype;
  float pfwd;
};

__device__ __forceinline__ float remap0(float x) { return x > 0.0f ? x : 1.0f; }

// shade_soa.bsdf_pdf_value: 1/(4 pi) for isotropic, else the clamped
// cosine of the normalized direction over pi
__device__ __forceinline__ float bsdf_pdf(int mtype, float nx, float ny,
                                          float nz, float dx, float dy,
                                          float dz) {
  normalize_safe(dx, dy, dz);
  const float cos_t = dx * nx + dy * ny + dz * nz;
  return mtype == M_ISO ? INV_4PI_F : fmaxf(cos_t / PI_F, 0.0f);
}

// shade_soa.evaluate_bsdf: the reference's direction-free BSDF value
__device__ __forceinline__ void eval_bsdf(int mtype, const float* m, float& r,
                                          float& g, float& b) {
  const float k = mtype == M_LAM ? INV_PI_F : 0.0f;
  if (mtype == M_ISO) {
    r = m[1] * INV_4PI_F;
    g = m[2] * INV_4PI_F;
    b = m[3] * INV_4PI_F;
  } else {
    r = m[1] * k;
    g = m[2] * k;
    b = m[3] * k;
  }
}

// random_cosine_direction through the reference ONB (onb.h:4-14)
__device__ __forceinline__ void cosine_dir(float nx, float ny, float nz,
                                           float u1, float u2, float& x,
                                           float& y, float& z) {
  float wx = nx, wy = ny, wz = nz;
  normalize_safe(wx, wy, wz);
  const bool pick_axis = fabsf(wx) > 0.9f;
  const float axx = pick_axis ? 0.0f : 1.0f;
  const float axy = pick_axis ? 1.0f : 0.0f;
  float vx = wy * 0.0f - wz * axy;
  float vy = wz * axx - wx * 0.0f;
  float vz = wx * axy - wy * axx;
  normalize_safe(vx, vy, vz);
  const float ux = wy * vz - wz * vy;
  const float uy = wz * vx - wx * vz;
  const float uz = wx * vy - wy * vx;
  const float phi = TWO_PI_F * u1;
  const float sq = sqrtf(u2);
  const float lx = cosf(phi) * sq;
  const float ly = sinf(phi) * sq;
  const float lz = sqrtf(1.0f - u2);
  x = lx * ux + ly * vx + lz * wx;
  y = lx * uy + ly * vy + lz * wy;
  z = lx * uz + ly * vz + lz * wz;
}

// uniform_sphere_direction
__device__ __forceinline__ void sphere_dir(float u1, float u2, float& x,
                                           float& y, float& z) {
  z = 1.0f - 2.0f * u1;
  const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const float phi = TWO_PI_F * u2;
  x = r * cosf(phi);
  y = r * sinf(phi);
}

// Sum_{i=lo..m} miscut[i] * prod_{q=i+1..m} rat2[q]: a row sum of
// models.bdpt.mis_strategy_table by one backward product scan over the
// lane's own slots (bdpt_kernel.py mis_suffix_sum).
__device__ float suffix_sum(const Verts& v, int m, int lo) {
  float s = 0.0f, prod = 1.0f;
  for (int i = m; i >= 0 && i >= lo; --i) {
    if ((int)v.at(i, V_FLAGS) & F_MISCUT) s = s + prod;
    prod = prod * v.at(i, V_RAT2);
  }
  return s;
}

// trace_path (camera.h:325-370) for at most `steps` bounces from r with
// throughput (tr, tg, tb), drawing from slot0 + bounce * (NT + V), its
// closest hits from the provider (bvh_walk.cuh: BruteHit or WalkHit over
// Counts, passed by value; the rays count in the provider's counters),
// with VOLS the free-flight override over `vol` after each.  Stores one
// vertex per surface or volume hit at slots off, off+1, ... and returns
// how many.
template <bool VOLS, class Tab, class Hits>
__device__ int trace(const Tab& s, const VolTables* vol, const Params& p, const Stream& st,
                     const Verts& v, int steps, int slot0, int off, Ray r,
                     float tr, float tg, float tb, bool collect_bg, float& bg_r,
                     float& bg_g, float& bg_b, Prev pv, Hits hits) {
  const int ntv = trace_slots<VOLS>(p);
  int n = 0;
  for (int b = 0; b < steps; ++b) {
    hits.c.rays += 1;
    const Hit h = hits(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
    const int best = h.tri;
    float t_hit = h.t;
    float gnx, gny, gnz;
    int mid;
    bool in_vol = false;
    if constexpr (VOLS) {
      const int uv = slot0 + b * ntv + NT;  // this bounce's free-flight draws
      in_vol = free_flight(*vol, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t_hit, mid,
                           [&](int k) { return st.draw(uv + k); });
    }
    if (in_vol) {
      // the reference's arbitrary normal (1, 0, 0), front face true
      // (constant_medium.h:48-49): set against the ray, the flip below
      // yields front; every use of a volume vertex's normal is an abs()
      // or guarded by the isotropic phase, so its sign reaches no sum
      gnx = r.dx < 0.0f ? 1.0f : -1.0f;
      gny = 0.0f;
      gnz = 0.0f;
    } else if (best < 0) {  // miss -> background (light-table tail)
      if (collect_bg) {
        bg_r = bg_r + tr * s.lgt[LGT_TAIL + 0];
        bg_g = bg_g + tg * s.lgt[LGT_TAIL + 1];
        bg_b = bg_b + tb * s.lgt[LGT_TAIL + 2];
      }
      break;
    } else {
      hits.surface(best, gnx, gny, gnz, mid);
    }
    const bool front = (r.dx * gnx + r.dy * gny + r.dz * gnz) < 0.0f;
    const float nx = front ? gnx : -gnx;
    const float ny = front ? gny : -gny;
    const float nz = front ? gnz : -gnz;
    const float px = r.ox + t_hit * r.dx;
    const float py = r.oy + t_hit * r.dy;
    const float pz = r.oz + t_hit * r.dz;

    const float* m = &s.mat[mid * MAT_STRIDE];
    const int mtype = (int)m[0];
    const bool is_light = mtype == M_LIGHT;
    const bool delta = mtype == M_METAL || mtype == M_DIEL;
    const bool emit_on = is_light && front;
    int flags = F_VALID | (delta ? F_DELTA : 0) | (is_light ? F_LIGHT : 0);
    const int slot = off + b;

    if (p.mis) {
      // forward / reverse area pdfs (models.bdpt.trace_subpath): every
      // scattering pdf of the material set ignores the incoming direction
      float sx = px - pv.px, sy = py - pv.py, sz = pz - pv.pz;
      const float dist2 = fmaxf(sx * sx + sy * sy + sz * sz, 1e-30f);
      normalize_safe(sx, sy, sz);
      const float cos_cur = fabsf(nx * sx + ny * sy + nz * sz);
      const float cos_prev = fabsf(pv.nx * sx + pv.ny * sy + pv.nz * sz);
      const float pdf_sa_f =
          pv.delta ? 0.0f : bsdf_pdf(pv.mtype, pv.nx, pv.ny, pv.nz, sx, sy, sz);
      const float pfwd = pdf_sa_f * cos_cur / dist2;
      const float prev_rev =
          delta ? 1.0f
                : bsdf_pdf(mtype, nx, ny, nz, -sx, -sy, -sz) * cos_prev / dist2;
      const float rat = prev_rev / remap0(pv.pfwd);
      v.at(slot, V_PFWD) = pfwd;
      v.at(slot, V_RAT2) = rat * rat;
      if (!delta && !pv.delta) flags |= F_MISCUT;
      pv = Prev{px, py, pz, nx, ny, nz, delta, mtype, pfwd};
    }
    v.at(slot, V_PX) = px;
    v.at(slot, V_PY) = py;
    v.at(slot, V_PZ) = pz;
    v.at(slot, V_NX) = nx;
    v.at(slot, V_NY) = ny;
    v.at(slot, V_NZ) = nz;
    v.at(slot, V_TR) = tr;
    v.at(slot, V_TG) = tg;
    v.at(slot, V_TB) = tb;
    v.at(slot, V_ER) = emit_on ? m[1] : 0.0f;
    v.at(slot, V_EG) = emit_on ? m[2] : 0.0f;
    v.at(slot, V_EB) = emit_on ? m[3] : 0.0f;
    v.at(slot, V_MAT) = (float)mid;
    v.at(slot, V_FLAGS) = (float)flags;
    n = b + 1;
    if (is_light) break;  // lights do not scatter

    const float alb_r = m[1], alb_g = m[2], alb_b = m[3];
    const int u0 = slot0 + b * ntv;
    float ndx, ndy, ndz;
    if (mtype == M_METAL) {
      // material.h:73-83
      const float u_f1 = st.draw(u0 + TU_FZ1);
      const float u_f2 = st.draw(u0 + TU_FZ2);
      const float dn = r.dx * nx + r.dy * ny + r.dz * nz;
      float rfx = r.dx - 2.0f * dn * nx;
      float rfy = r.dy - 2.0f * dn * ny;
      float rfz = r.dz - 2.0f * dn * nz;
      normalize_safe(rfx, rfy, rfz);
      float sx, sy, sz;
      sphere_dir(u_f1, u_f2, sx, sy, sz);
      const float fuzz = m[4];
      ndx = rfx + fuzz * sx;
      ndy = rfy + fuzz * sy;
      ndz = rfz + fuzz * sz;
      tr = tr * alb_r;
      tg = tg * alb_g;
      tb = tb * alb_b;
    } else if (mtype == M_DIEL) {
      // material.h:96-116; attenuation 1
      const float u_dl = st.draw(u0 + TU_DIEL);
      const float ior = m[5];
      const float ri = front ? 1.0f / ior : ior;
      float udx = r.dx, udy = r.dy, udz = r.dz;
      normalize_safe(udx, udy, udz);
      const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      float r0 = (1.0f - ri) / (1.0f + ri);
      r0 = r0 * r0;
      // powf, as torch's pow of the plain version's Schlick term
      const float schlick = r0 + (1.0f - r0) * powf(1.0f - cos_t, 5.0f);
      if (ri * sin_t > 1.0f || schlick > u_dl) {
        const float udn = udx * nx + udy * ny + udz * nz;
        ndx = udx - 2.0f * udn * nx;
        ndy = udy - 2.0f * udn * ny;
        ndz = udz - 2.0f * udn * nz;
      } else {
        const float perp_x = ri * (udx + cos_t * nx);
        const float perp_y = ri * (udy + cos_t * ny);
        const float perp_z = ri * (udz + cos_t * nz);
        const float par = -sqrtf(fabsf(
            1.0f - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z)));
        ndx = perp_x + par * nx;
        ndy = perp_y + par * ny;
        ndz = perp_z + par * nz;
      }
    } else {
      // bsdf-pdf sampling (camera.h:361-368)
      const float u_b1 = st.draw(u0 + TU_B1);
      const float u_b2 = st.draw(u0 + TU_B2);
      const bool is_iso = mtype == M_ISO;
      if (is_iso) {
        sphere_dir(u_b1, u_b2, ndx, ndy, ndz);
      } else {
        cosine_dir(nx, ny, nz, u_b1, u_b2, ndx, ndy, ndz);
      }
      const float pdf_val = bsdf_pdf(mtype, nx, ny, nz, ndx, ndy, ndz);
      float cx = ndx, cy = ndy, cz = ndz;
      normalize_safe(cx, cy, cz);
      const float cos_t = nx * cx + ny * cy + nz * cz;
      float scat_pdf = 0.0f;
      if (is_iso) {
        scat_pdf = INV_4PI_F;
      } else if (mtype == M_LAM) {
        scat_pdf = cos_t < 0.0f ? 0.0f : cos_t / PI_F;
      }
      if (!(pdf_val > 0.0f)) break;
      const float w = scat_pdf / pdf_val;
      tr = tr * alb_r * w;
      tg = tg * alb_g * w;
      tb = tb * alb_b * w;
    }
    r = Ray{px, py, pz, ndx, ndy, ndz};
  }
  return n;
}

// What a sample's connections start from: the two subpath lengths and the
// background plus camera-vertex emission (bg + em, the first term of the
// sample's sum).
struct Sub {
  int n_cam, n_light;
  float r, g, b;
};

// The camera and light subpaths of bidirectional_color (camera.h:294-323)
// from the primary ray r0, with the camera-vertex emission; its hits from
// the provider.
template <bool VOLS, class Tab, class Hits>
__device__ Sub subpaths(const Tab& s, const VolTables* vol, const Params& p,
                        const Stream& st, const Verts& cam, const Verts& lgt, Ray r0,
                        Hits hits) {
  const int depth = p.depth;
  const bool mis = p.mis;
  const int ntv = trace_slots<VOLS>(p);

  // ---- camera subpath; its previous "vertex" is the delta camera
  float bg_r = 0.0f, bg_g = 0.0f, bg_b = 0.0f;
  Prev pc{};
  if (mis) {
    float nx = r0.dx, ny = r0.dy, nz = r0.dz;
    normalize_safe(nx, ny, nz);
    pc = Prev{r0.ox, r0.oy, r0.oz, nx, ny, nz, true, M_LAM, 1.0f};
  }
  const int n_cam = trace<VOLS>(s, vol, p, st, cam, depth, 0, 0, r0, 1.0f, 1.0f, 1.0f,
                                true, bg_r, bg_g, bg_b, pc, hits);

  const float total = s.lgt[LGT_TAIL + 3];
  const float inv_area = total > 0.0f ? 1.0f / fmaxf(total, 1e-30f) : 0.0f;

  // ---- camera-vertex emission (camera.h:305-309); under MIS the (s=0, t)
  // strategy's weight against moving the cut to any earlier vertex
  float em_r = 0.0f, em_g = 0.0f, em_b = 0.0f;
  for (int b = 0; b < n_cam; ++b) {
    if ((int)cam.at(b, V_FLAGS) & F_DELTA) continue;
    float w = 1.0f;
    if (mis) {
      const float suf = suffix_sum(cam, b, 0);
      cam.at(b, V_SUF) = suf;  // for connect(): every vertex it starts from
      const float r_em = inv_area / remap0(cam.at(b, V_PFWD));
      w = 1.0f / (1.0f + r_em * r_em * suf);
    }
    em_r = em_r + cam.at(b, V_TR) * cam.at(b, V_ER) * w;
    em_g = em_g + cam.at(b, V_TG) * cam.at(b, V_EG) * w;
    em_b = em_b + cam.at(b, V_TB) * cam.at(b, V_EB) * w;
  }

  // ---- light subpath start (camera.h:372-418)
  const int ls0 = depth * ntv;
  const float u_pick = st.draw(ls0 + LS_PICK);
  const float u_lu = st.draw(ls0 + LS_U);
  const float u_lv = st.draw(ls0 + LS_V);
  const float u_d1 = st.draw(ls0 + LS_D1);
  const float u_d2 = st.draw(ls0 + LS_D2);
  // area CDF scan, accumulated in f32 (triangle.h:210-219); past the end
  // the last light, like the reference's &tris.back() default
  const float pick = u_pick * total;
  float acc = 0.0f;
  int lidx = -1;
  for (int li = 0; li < p.L; ++li) {
    acc = acc + s.lgt[li * LGT_STRIDE + 12];
    if (lidx < 0 && pick <= acc) lidx = li;
  }
  if (lidx < 0) lidx = p.L - 1;
  const float* lt = &s.lgt[lidx * LGT_STRIDE];
  const bool flip = (u_lu + u_lv) > 1.0f;
  const float bu = flip ? 1.0f - u_lu : u_lu;
  const float bv = flip ? 1.0f - u_lv : u_lv;
  const float spx = lt[0] + bu * lt[3] + bv * lt[6];
  const float spy = lt[1] + bu * lt[4] + bv * lt[7];
  const float spz = lt[2] + bu * lt[5] + bv * lt[8];
  const float snx = lt[9], sny = lt[10], snz = lt[11];
  const int smat = (int)s.lgt[LGT_TAIL + 4 + lidx];
  const float* sm = &s.mat[smat * MAT_STRIDE];
  const int smtype = (int)sm[0];
  // emitter emission, front face forced
  const float le_r = smtype == M_LIGHT ? sm[1] : 0.0f;
  const float le_g = smtype == M_LIGHT ? sm[2] : 0.0f;
  const float le_b = smtype == M_LIGHT ? sm[3] : 0.0f;
  const bool path_ok =
      total > 0.0f && (le_r * le_r + le_g * le_g + le_b * le_b) > 0.0f;

  int n_light = 0;
  if (path_ok) {
    const float thr0 = 1.0f / fmaxf(inv_area, 1e-8f);
    lgt.at(0, V_PX) = spx;
    lgt.at(0, V_PY) = spy;
    lgt.at(0, V_PZ) = spz;
    lgt.at(0, V_NX) = snx;
    lgt.at(0, V_NY) = sny;
    lgt.at(0, V_NZ) = snz;
    lgt.at(0, V_TR) = thr0;
    lgt.at(0, V_TG) = thr0;
    lgt.at(0, V_TB) = thr0;
    lgt.at(0, V_ER) = le_r;
    lgt.at(0, V_EG) = le_g;
    lgt.at(0, V_EB) = le_b;
    lgt.at(0, V_MAT) = (float)smat;
    // emitter slot: pfwd = area pdf, rat2 unused, cut always connectable
    lgt.at(0, V_FLAGS) = (float)(F_VALID | F_LIGHT | (mis ? F_MISCUT : 0));
    if (mis) {
      lgt.at(0, V_PFWD) = inv_area;
      lgt.at(0, V_RAT2) = 0.0f;
    }
    n_light = 1;

    // cosine exit (camera.h:407-415)
    float ldx, ldy, ldz;
    cosine_dir(snx, sny, snz, u_d1, u_d2, ldx, ldy, ldz);
    normalize_safe(ldx, ldy, ldz);
    const float cos_theta = fmaxf(snx * ldx + sny * ldy + snz * ldz, 0.0f);
    if (cos_theta > 0.0f && depth > 1) {
      const float pdf_dir = fmaxf(cos_theta / PI_F, 1e-8f);
      const float scale = cos_theta / pdf_dir;
      const Ray lr{spx + 0.001f * snx, spy + 0.001f * sny, spz + 0.001f * snz,
                   ldx, ldy, ldz};
      const Prev pl{spx, spy, spz, snx, sny, snz, false, smtype, inv_area};
      float unused_r = 0.0f, unused_g = 0.0f, unused_b = 0.0f;
      n_light += trace<VOLS>(s, vol, p, st, lgt, depth - 1, depth * ntv + NLS, 1, lr,
                             thr0 * le_r * scale, thr0 * le_g * scale,
                             thr0 * le_b * scale, false, unused_r, unused_g,
                             unused_b, pl, hits);
    }
    if (mis) {  // the light side's suffix sums, for connect()
      for (int t = 0; t < n_light; ++t) {
        if (!((int)lgt.at(t, V_FLAGS) & F_DELTA)) lgt.at(t, V_SUF) = suffix_sum(lgt, t, 0);
      }
    }
  }
  return Sub{n_cam, n_light, bg_r + em_r, bg_g + em_g, bg_b + em_b};
}

// The connection loop's place: the next (sc, t) pair to examine, the sum
// of the current camera vertex's connections (p*) and the sum of the
// finished camera vertices (c*).  The loop can stop at a pair and resume
// there: a resumed pair takes the same tests again and passes them again.
struct Conn {
  int sc = 0, t = 0;
  float pr = 0.0f, pg = 0.0f, pb = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
};

// The connections (camera.h:316-320, 440-475) from the place c onwards, in
// (sc, t) order.  A pair that passes every test before the shadow ray
// (a candidate) goes to the visibility policy V:
//   V::stop()  true: leave c at this candidate and return false;
//   V::visible(o, d, tmax)  the shadow ray's answer, true if unoccluded
//     (the policy counts the visible pair), false to skip the pair.
// Returns true when every pair is done; c then holds the sum.
template <class Tab, class V>
__device__ bool connect(const Tab& s, const Params& p, const Verts& cam,
                        const Verts& lgt, int n_cam, int n_light, Conn& c,
                        V& vis) {
  const int depth = p.depth;
  const bool mis = p.mis;
  for (; c.sc < n_cam; ++c.sc, c.t = 0) {
    const int sc = c.sc;
    if ((int)cam.at(sc, V_FLAGS) & F_DELTA) continue;
    const int cmat = (int)cam.at(sc, V_MAT);
    const float* cm = &s.mat[cmat * MAT_STRIDE];
    const int cmt = (int)cm[0];
    float fcr, fcg, fcb;
    eval_bsdf(cmt, cm, fcr, fcg, fcb);
    if (!((fcr * fcr + fcg * fcg + fcb * fcb) > 0.0f)) continue;
    const float cfr = cam.at(sc, V_TR) * fcr;
    const float cfg = cam.at(sc, V_TG) * fcg;
    const float cfb = cam.at(sc, V_TB) * fcb;
    const float cpx = cam.at(sc, V_PX), cpy = cam.at(sc, V_PY),
                cpz = cam.at(sc, V_PZ);
    const float cnx = cam.at(sc, V_NX), cny = cam.at(sc, V_NY),
                cnz = cam.at(sc, V_NZ);
    for (; c.t < n_light; ++c.t) {
      const int t = c.t;
      const int lfl = (int)lgt.at(t, V_FLAGS);
      if (lfl & F_DELTA) continue;
      const int lmat = (int)lgt.at(t, V_MAT);
      const float* lm = &s.mat[lmat * MAT_STRIDE];
      const int lmt = (int)lm[0];
      float flr, flg, flb;
      if (lfl & F_LIGHT) {  // emitters use raw emission (camera.h:462-467)
        flr = lgt.at(t, V_ER);
        flg = lgt.at(t, V_EG);
        flb = lgt.at(t, V_EB);
      } else {
        eval_bsdf(lmt, lm, flr, flg, flb);
      }
      if (!((flr * flr + flg * flg + flb * flb) > 0.0f)) continue;

      const float dxx = lgt.at(t, V_PX) - cpx;
      const float dyy = lgt.at(t, V_PY) - cpy;
      const float dzz = lgt.at(t, V_PZ) - cpz;
      const float dist2 = dxx * dxx + dyy * dyy + dzz * dzz;
      if (!(dist2 > 0.0f)) continue;
      const float dist = sqrtf(fmaxf(dist2, 1e-30f));
      const float inv_dist = 1.0f / dist;
      const float dux = dxx * inv_dist, duy = dyy * inv_dist,
                  duz = dzz * inv_dist;
      const float lnx = lgt.at(t, V_NX), lny = lgt.at(t, V_NY),
                  lnz = lgt.at(t, V_NZ);
      const float sgn_c = dux * cnx + duy * cny + duz * cnz;
      const float sgn_l = lnx * -dux + lny * -duy + lnz * -duz;
      const float cos_c = fabsf(sgn_c);
      const float cos_l = fabsf(sgn_l);
      if (!(cos_c > 0.0f && cos_l > 0.0f)) continue;
      // bdpt-mis: one-sided connections, isotropic scatterers two-sided
      if (mis && !((cmt == M_ISO || sgn_c > 0.0f) && (lmt == M_ISO || sgn_l > 0.0f)))
        continue;
      // visible(a, b) (camera.h:425-438) with the endpoint margin
      const float max_t = dist - 0.001f;
      if (!(max_t > 0.0f)) continue;
      if (vis.stop()) return false;
      if (!vis.visible(cpx + 0.001f * dux, cpy + 0.001f * duy,
                       cpz + 0.001f * duz, dux, duy, duz, max_t * SHADOW_SCALE))
        continue;

      const float g = (cos_c * cos_l) / fmaxf(dist2, 1e-30f);
      float c_r = cfr * (lgt.at(t, V_TR) * flr) * g;
      float c_g = cfg * (lgt.at(t, V_TG) * flg) * g;
      float c_b = cfb * (lgt.at(t, V_TB) * flb) * g;
      if (mis) {
        // reverse pdfs of the two junction vertices, area measure; both
        // are non-delta here, so a zero is genuine and not remapped
        const float d2s = fmaxf(dist2, 1e-30f);
        const float rev_c =
            bsdf_pdf(lmt, lnx, lny, lnz, -dux, -duy, -duz) * cos_c / d2s;
        const float rev_l = bsdf_pdf(cmt, cnx, cny, cnz, dux, duy, duz) * cos_l / d2s;
        const float rc = rev_c / remap0(cam.at(sc, V_PFWD));
        const float rl = rev_l / remap0(lgt.at(t, V_PFWD));
        // realizability clamp: a strategy keeping i vertices on one side
        // needs the other side <= depth, i >= k - depth, k = sc + t + 2;
        // where it cuts nothing, each side's scan down to slot 0 is stored
        const int lo = sc + t + 2 - depth;
        const float suf_c = lo <= 0 ? cam.at(sc, V_SUF) : suffix_sum(cam, sc, lo);
        const float suf_l = lo <= 0 ? lgt.at(t, V_SUF) : suffix_sum(lgt, t, lo);
        const float sum_c = rc * rc * suf_c;
        const float sum_l = rl * rl * suf_l;
        const float w = 1.0f / (1.0f + sum_c + sum_l);
        c_r = c_r * w;
        c_g = c_g * w;
        c_b = c_b * w;
      }
      c.pr = c.pr + c_r;
      c.pg = c.pg + c_g;
      c.pb = c.pb + c_b;
    }
    c.cr = c.cr + c.pr;
    c.cg = c.cg + c.pg;
    c.cb = c.cb + c.pb;
    c.pr = c.pg = c.pb = 0.0f;
  }
  return true;
}

// get_ray (camera.h:199-213): BDPT's jitter is word x0 of two threefry
// calls keyed by the two tail keys (bdpt_kernel.py:994-997)
template <class Tab>
__device__ __forceinline__ Ray stratum_ray(const float* c, const Tab& s,
                                           int nj, uint32_t ridu, float i,
                                           float j, float sx, float sy) {
  uint32_t a0 = ridu, a1 = 0u, b0 = ridu, b1 = 0u;
  threefry2x32(s.keys[2 * nj], s.keys[2 * nj + 1], a0, a1);
  threefry2x32(s.keys[2 * nj + 2], s.keys[2 * nj + 3], b0, b1);
  const float u0 = bits_to_unit(a0);
  const float u1 = bits_to_unit(b0);
  const float recip = c[12];
  const float offx = (sx + u0) * recip - 0.5f;
  const float offy = (sy + u1) * recip - 0.5f;
  const float a = i + offx;
  const float e = j + offy;
  return Ray{c[9], c[10], c[11],
             c[0] + a * c[3] + e * c[6] - c[9],
             c[1] + a * c[4] + e * c[7] - c[10],
             c[2] + a * c[5] + e * c[8] - c[11]};
}

template <class Tab>
__device__ __forceinline__ void stage_tables(const Params& p, Tab& s) {
  for (int k = threadIdx.x; k < MAX_MATS * MAT_STRIDE; k += blockDim.x) s.mat[k] = p.mat[k];
  for (int k = threadIdx.x; k < LGT_WORDS; k += blockDim.x) s.lgt[k] = p.lgt[k];
  for (int k = threadIdx.x; k < p.nkeys; k += blockDim.x) s.keys[k] = p.keys[k];
}

// Sample k of `lane`: its primary ray and draw stream.  Rays mode: the
// lane's ray, drawn by ray id rid (or from the injected buffer).  Pixels
// mode: stratum k of pixel rid, drawn by sample id pix*spp + k.
template <bool VOLS, class Tab>
__device__ __forceinline__ Ray primary(const Params& p, const Tab& s,
                                       int lane, int rid, uint32_t k,
                                       Stream& st) {
  if (!p.pixels) {
    st = Stream{p.ubuf, p.B, lane, s.keys, (uint32_t)rid};
    return Ray{p.in[0][lane], p.in[1][lane], p.in[2][lane],
               p.in[3][lane], p.in[4][lane], p.in[5][lane]};
  }
  const int ntv = trace_slots<VOLS>(p);
  const int nj = p.depth * ntv + NLS + (p.depth - 1) * ntv;
  const int S = p.sqrt_spp;
  const uint32_t ridu = (uint32_t)rid * (uint32_t)(S * S) + k;
  st = Stream{nullptr, p.B, lane, s.keys, ridu};
  return stratum_ray(p.cam, s, nj, ridu, p.in[0][lane], p.in[1][lane],
                     (float)(k % (uint32_t)S), (float)(k / (uint32_t)S));
}

// exact counters: warp sums, one 64-bit atomic per warp and counter
__device__ __forceinline__ void flush_counts(const Params& p, const Counts& c) {
  warp_add(c.rays, &p.counters[0]);
  warp_add(c.shadow, &p.counters[1]);
  warp_add(c.nodes, &p.counters[2]);
  warp_add(c.boxes, &p.counters[3]);
  warp_add(c.tests, &p.counters[4]);
  warp_add(c.hits, &p.counters[5]);
}

// The walk mode's shadow rays, shared across the warp.  Each lane goes
// over its connection candidates in (sc, t) order and pushes their shadow
// rays into the warp's ring; the 32 lanes walk the ring's rays together
// (lane i takes entries i, i + 32, ...), one occlusion bit an entry; then
// each lane runs its connection loop again in the same order and reads its
// bits instead of walking.  A warp whose candidates outgrow the ring does
// this in rounds, the lanes taking the ring's entries in lane order.
constexpr int RING = 256;
struct Ring {
  float ox[RING], oy[RING], oz[RING], dx[RING], dy[RING], dz[RING], tmax[RING];
  unsigned occ[RING / 32];  // bit e % 32 of word e / 32: entry e occluded
};

// Counts a lane's candidates.
struct CountShadow {
  int n = 0;

  __device__ __forceinline__ bool stop() const { return false; }
  __device__ __forceinline__ bool visible(float, float, float, float, float,
                                          float, float) {
    ++n;
    return false;
  }
};

// Pushes the next candidates' shadow rays into ring entries [at, end).
struct PushShadow {
  Ring& ring;
  int at, end;

  __device__ __forceinline__ bool stop() const { return at == end; }
  __device__ __forceinline__ bool visible(float ox, float oy, float oz, float dx,
                                          float dy, float dz, float tmax) {
    ring.ox[at] = ox;
    ring.oy[at] = oy;
    ring.oz[at] = oz;
    ring.dx[at] = dx;
    ring.dy[at] = dy;
    ring.dz[at] = dz;
    ring.tmax[at] = tmax;
    ++at;
    return false;
  }
};

// Reads the next candidates' answers from ring entries [at, end); the
// owner counts a visible pair.
struct ReadShadow {
  const Ring& ring;
  int at, end;
  Counts& c;

  __device__ __forceinline__ bool stop() const { return at == end; }
  __device__ __forceinline__ bool visible(float, float, float, float, float,
                                          float, float) {
    const bool occluded = (ring.occ[at >> 5] >> (at & 31)) & 1u;
    ++at;
    if (occluded) return false;
    c.shadow += 1;
    return true;
  }
};

// Visibility by sweeping each shadow ray where it comes up (the brute mode:
// a sweep is T tests from shared memory, which costs less than the two
// extra passes over a sample's connections that sharing it takes).
template <class Hits>
struct ShadowNow {
  Hits hits;

  __device__ __forceinline__ bool stop() const { return false; }
  __device__ __forceinline__ bool visible(float ox, float oy, float oz, float dx,
                                          float dy, float dz, float tmax) {
    if (hits.occluded(ox, oy, oz, dx, dy, dz, tmax)) return false;
    hits.c.shadow += 1;
    return true;
  }
};

// The one body of both modes: a persistent grid, one sample a work item
// (walk_sched.cuh), the vertex scratch a resident thread's; closest hits
// and shadow rays from the provider (BruteHit or WalkHit over cnt), each
// warp's shadow rays shared across its lanes through `ring` (SHARE, the
// walk mode), or each lane's swept where it comes up (ring unused).
template <bool SHARE, bool VOLS, class Tab, class Hits>
__device__ __forceinline__ void samples(const Params& p, const Tab& s, const VolTables* vol,
                                        Ring* ring, Hits hits, Counts& cnt) {
  const int wl = threadIdx.x & 31;
  const int stride = p.mis ? VTX_STRIDE_MIS : VTX_STRIDE;
  const size_t thread = blockIdx.x * BLOCK + threadIdx.x;
  const Verts cam{p.vtx + thread * 2 * p.depth * stride, stride};
  const Verts lgt{cam.base + p.depth * stride, stride};
  const int n = p.B * p.nk;
  for (;;) {
    const int base = warp_take(p.next);
    if (base >= n) break;
    const int item = base + wl;
    int lane = 0, kk = 0, rid = -1;
    if (item < n) {
      lane = item / p.nk;
      kk = item - lane * p.nk;
      rid = p.rid[lane];
    }
    Sub sub{0, 0, 0.0f, 0.0f, 0.0f};
    Conn summed;
    Stream st;
    if (rid >= 0) {
      const Ray r = primary<VOLS>(p, s, lane, rid, (uint32_t)(p.k0 + kk), st);
      sub = subpaths<VOLS>(s, vol, p, st, cam, lgt, r, hits);
    }
    if constexpr (!SHARE) {
      if (rid >= 0) {
        ShadowNow<Hits> vis{hits};
        connect(s, p, cam, lgt, sub.n_cam, sub.n_light, summed, vis);
      }
    } else {
      int todo = 0;
      if (rid >= 0) {
        Conn c;
        CountShadow count;
        connect(s, p, cam, lgt, sub.n_cam, sub.n_light, c, count);
        todo = count.n;
      }
      Conn pushed;
      for (int left = warp_sum(todo); left > 0; left -= RING) {
        const int at = warp_exclusive_sum(todo);
        const int got = max(0, min(todo, RING - at));
        if (got > 0) {
          PushShadow push{*ring, at, at + got};
          connect(s, p, cam, lgt, sub.n_cam, sub.n_light, pushed, push);
        }
        __syncwarp();
        const int m = min(left, RING);
        for (int e0 = 0; e0 < m; e0 += 32) {
          const int e = e0 + wl;
          const bool occluded = e < m && hits.occluded(ring->ox[e], ring->oy[e], ring->oz[e],
                                                       ring->dx[e], ring->dy[e], ring->dz[e],
                                                       ring->tmax[e]);
          const unsigned bits = __ballot_sync(0xffffffffu, occluded);
          if (wl == 0) ring->occ[e0 >> 5] = bits;
        }
        __syncwarp();
        if (got > 0) {
          ReadShadow read{*ring, at, at + got, cnt};
          connect(s, p, cam, lgt, sub.n_cam, sub.n_light, summed, read);
        }
        __syncwarp();
        todo -= got;
      }
      if (rid >= 0) {  // the pairs after the last candidate: no bit left to read
        ReadShadow read{*ring, 0, 0, cnt};
        connect(s, p, cam, lgt, sub.n_cam, sub.n_light, summed, read);
      }
    }
    if (item >= n) continue;
    const size_t o = (size_t)kk * p.B + lane;
    p.out_r[o] = rid >= 0 ? sub.r + summed.cr : 0.0f;
    p.out_g[o] = rid >= 0 ? sub.g + summed.cg : 0.0f;
    p.out_b[o] = rid >= 0 ? sub.b + summed.cb : 0.0f;
  }
}

// Brute mode: every closest hit and shadow ray sweeps the triangle table
// in shared memory.  At least BRUTE_BLOCKS blocks an SM, chosen on the
// card (PERF.md §6).
constexpr int BRUTE_BLOCKS = 5;

__global__ void __launch_bounds__(BLOCK, BRUTE_BLOCKS) bdpt_megakernel(const Params p) {
  __shared__ BruteTablesOf<Tables> s;
  for (int k = threadIdx.x; k < p.T * TRI_STRIDE; k += blockDim.x) s.tri[k] = p.tri[k];
  stage_tables(p, s.shade);
  __syncthreads();
  Counts cnt;
  samples<false, false>(p, s.shade, nullptr, nullptr, BruteHit<Counts>{s.tri, p.T, cnt}, cnt);
  flush_counts(p, cnt);
}

// The brute mode on a scene with volumes.
__global__ void __launch_bounds__(BLOCK, BRUTE_BLOCKS) bdpt_megakernel_vol(const Params p) {
  __shared__ BruteTablesOf<TablesVol> s;
  __shared__ VolTables sv;
  for (int k = threadIdx.x; k < p.T * TRI_STRIDE; k += blockDim.x) s.tri[k] = p.tri[k];
  stage_tables(p, s.shade);
  stage_volumes(p.vol, p.volm, p.V, p.VT, sv);
  __syncthreads();
  Counts cnt;
  samples<false, true>(p, s.shade, &sv, nullptr, BruteHit<Counts>{s.tri, p.T, cnt}, cnt);
  flush_counts(p, cnt);
}

// Walk mode: closest hits walk the BVH over (T_MIN, inf), shadow rays
// over [T_MIN, tmax] with bvh_walk<true> (the clustered mode of bpt_tpu's
// kernel, use_clusters: more than 512 triangles).  WALK_BLOCKS blocks an
// SM, at least (the kernel is held to 128 registers; it takes 96) and at
// most (bpt_bdpt_blocks): the card fits five, which ran no faster
// than four and takes 184 MB more vertex scratch at depth 80 with MIS
// (PERF.md §6).
constexpr int WALK_BLOCKS = 4;

__global__ void __launch_bounds__(BLOCK, WALK_BLOCKS) bdpt_megakernel_walk(const Params p) {
  __shared__ Tables s;
  __shared__ Ring rings[BLOCK / 32];
  stage_tables(p, s);
  __syncthreads();
  Counts cnt;
  samples<true, false>(p, s, nullptr, &rings[threadIdx.x >> 5],
                       WalkHit<Counts>{p.g, p.mat_id, cnt}, cnt);
  flush_counts(p, cnt);
}

// The walk mode on a scene with volumes.
__global__ void __launch_bounds__(BLOCK, WALK_BLOCKS) bdpt_megakernel_walk_vol(const Params p) {
  __shared__ TablesVol s;
  __shared__ Ring rings[BLOCK / 32];
  __shared__ VolTables sv;
  stage_tables(p, s);
  stage_volumes(p.vol, p.volm, p.V, p.VT, sv);
  __syncthreads();
  Counts cnt;
  samples<true, true>(p, s, &sv, &rings[threadIdx.x >> 5],
                      WalkHit<Counts>{p.g, p.mat_id, cnt}, cnt);
  flush_counts(p, cnt);
}

}  // namespace bdpt
}  // namespace bpt

extern "C" {

// Launches the BDPT megakernel on `stream` on `grid` persistent blocks,
// with the work counter `next` (zeroed by the caller), the vertex scratch
// [grid*128][2][depth][stride] and, in pixels mode, the strata
// [k0, k0 + nk) (rays mode: 0, 1); returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a depth, key count,
// table size or work split the kernel does not take.  N > 0 selects the
// walk mode over the BVH (nodes, tris, mat_id; tri unused), N == 0 the
// brute mode over tri (T <= 512).  V > 0 volumes over VT boundary
// triangles (vol, volm: pack_vol_tables) select the _vol kernels, whose
// keys and ubuf hold NT + V slots a trace bounce.  Device pointers only.
int bpt_bdpt_megakernel(int pixels, int mis, int B, int T, int L, int depth,
                        int sqrt_spp, int nkeys, int N, int k0, int nk,
                        int grid, const float* tri, const float* nodes,
                        const float* tris, const int* mat_id, const float* mat,
                        const float* lgt, const uint32_t* keys, const float* cam,
                        const float* in0, const float* in1, const float* in2,
                        const float* in3, const float* in4, const float* in5,
                        const int* rid, const float* ubuf, float* vtx,
                        float* out_r, float* out_g, float* out_b,
                        unsigned long long* counters, int* next, int V, int VT,
                        const float* vol, const float* volm, void* stream) {
  using namespace bpt::bdpt;
  if (depth < 1 || depth > MAX_DEPTH || nkeys < 0 ||
      nkeys > (V > 0 ? MAX_KEYS_VOL : MAX_KEYS) || V < 0 || V > bpt::MAX_VOLS ||
      VT < 0 || VT > bpt::MAX_VOL_TRIS || (V > 0 && VT < 1) ||
      N < 0 || (N == 0 && (T < 0 || T > MAX_TRIS)) || L < 1 ||
      L > MAX_LIGHTS || sqrt_spp < 1 || grid < 1 || nk < 1 || k0 < 0 ||
      (!pixels && (k0 != 0 || nk != 1)) || (pixels && k0 + nk > sqrt_spp * sqrt_spp) ||
      (long long)B * nk > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.pixels = pixels;
  p.mis = mis;
  p.B = B;
  p.T = T;
  p.L = L;
  p.depth = depth;
  p.sqrt_spp = sqrt_spp;
  p.nkeys = nkeys;
  p.k0 = k0;
  p.nk = nk;
  p.next = next;
  p.tri = tri;
  p.g = bpt::Bvh{(const float4*)nodes, (const float4*)tris, N};
  p.mat_id = mat_id;
  p.mat = mat;
  p.lgt = lgt;
  p.keys = keys;
  p.cam = cam;
  p.in[0] = in0;
  p.in[1] = in1;
  p.in[2] = in2;
  p.in[3] = in3;
  p.in[4] = in4;
  p.in[5] = in5;
  p.rid = rid;
  p.ubuf = ubuf;
  p.vtx = vtx;
  p.out_r = out_r;
  p.out_g = out_g;
  p.out_b = out_b;
  p.counters = counters;
  p.V = V;
  p.VT = VT;
  p.vol = vol;
  p.volm = volm;
  if (B > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (N > 0 && V > 0) {
      bdpt_megakernel_walk_vol<<<grid, BLOCK, 0, st>>>(p);
    } else if (N > 0) {
      bdpt_megakernel_walk<<<grid, BLOCK, 0, st>>>(p);
    } else if (V > 0) {
      bdpt_megakernel_vol<<<grid, BLOCK, 0, st>>>(p);
    } else {
      bdpt_megakernel<<<grid, BLOCK, 0, st>>>(p);
    }
  }
  return (int)cudaGetLastError();
}

// Blocks of the BDPT megakernel the current device holds at once (its
// persistent grid), or a negative CUDA error code: bdpt_megakernel_walk
// (at most WALK_BLOCKS an SM) if walk, else bdpt_megakernel (the brute
// mode); their volume kernels if vols.
int bpt_bdpt_blocks(int walk, int vols) {
  using namespace bpt::bdpt;
  static int walk_cache[2][64], cache[2][64];
  if (walk)
    return bpt::resident_blocks(vols ? bdpt_megakernel_walk_vol : bdpt_megakernel_walk, BLOCK,
                                walk_cache[vols != 0], 64, WALK_BLOCKS);
  return bpt::resident_blocks(vols ? bdpt_megakernel_vol : bdpt_megakernel, BLOCK,
                              cache[vols != 0], 64);
}

}  // extern "C"
