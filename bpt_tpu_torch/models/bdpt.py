"""Bidirectional integrator — the wavefront form of bidirectional_color
(src/camera.h:294-475), counterpart of ``bpt_tpu.models.bdpt``.

Three stages, each a full-batch wave:

1. camera subpath: trace_path (camera.h:325-370) storing a vertex SoA of
   slot-major [S, B] tensors; per-vertex emission for non-delta vertices
   (camera.h:305-309) plus background on miss (camera.h:336-339).
2. light subpath: area-weighted emitter sample (camera.h:381-405; CDF
   searchsorted), throughput 1/max(pdf_area, 1e-8), cosine exit direction
   with throughput emission * cos / max(cos/pi, 1e-8) (camera.h:407-415),
   then the same trace for depth-1 more vertices.
3. connections: the (s, t) outer product, one [S_l * B] shadow wave per
   camera slot, with the reference's rules (camera.h:440-475).  Without
   MIS the pairs are summed unweighted, as the reference does; with MIS
   (integrator bdpt-mis) each pair carries its power-heuristic weight.

Randomness enters only through the uniform sources, so tests inject the
same uniforms here and in ``bpt_tpu``.  This wavefront is the plain version
the CUDA BDPT megakernel (``ops/kernels/bdpt_kernel.py``) is held against,
and the render's estimator wherever ``bdpt_fast`` takes its jnp branch, as
``bdpt_radiance`` is on ``bpt_tpu``'s jnp routes: there its traversals
(``ops.soa.closest_hit`` / ``any_hit``) launch the CUDA hit kernels on a
CUDA scene, ``closest_bvh`` / ``any_bvh`` with a BVH and ``closest_tri`` /
``any_tri`` without.  ``plain`` runs their torch versions instead, for
comparisons.

On a scene with constant-density volumes each traced bounce ends at the
free-flight override of ``ops.soa.apply_volumes``, as in ``bpt_tpu``;
shadow rays do not see volumes there either.

Not ported: ``bpt_tpu``'s live-prefix narrowed trace and its batched or
sparse connection waves (TPU study options, ROADMAP §2 "Not to port").
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.pt import default_uniforms_fn
from bpt_tpu_torch.ops import shade_soa as sh
from bpt_tpu_torch.ops import soa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.scene.types import MAT_ISOTROPIC, MAT_LIGHT, SceneTensors

# per-bounce uniform slots for trace_subpath
TU_B1 = 0  # bsdf dir sample
TU_B2 = 1
TU_DIEL = 2  # dielectric reflect choice
TU_FZ1 = 3  # metal fuzz sphere dir
TU_FZ2 = 4
NT = rng.BDPT_NT

# light-start uniform slots (one draw per sample)
LS_PICK = 0
LS_U = 1
LS_V = 2
LS_D1 = 3  # cosine exit dir
LS_D2 = 4
NLS = rng.BDPT_NLS

# relative endpoint margin for connection visibility: the reference advances
# the shadow origin by 0.001*du AND sets max_t = dist - 0.001, which puts the
# emitter plane exactly at max_t — occlusion then flips on fp rounding. The
# range shrinks so that the endpoint is excluded deterministically.
SHADOW_EPS_REL = 1e-4


class Vertices(NamedTuple):
    """path_vertex SoA (camera.h:236-243); tensors are [S, B] (slot-major)."""

    valid: torch.Tensor
    p: Vec3
    normal: Vec3
    wi: Vec3
    thr: Vec3
    emit: Vec3
    mat: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    delta: torch.Tensor
    is_light: torch.Tensor


class MisInfo(NamedTuple):
    """Per-slot MIS bookkeeping ([S, B] each, slot-major like Vertices).

    pfwd: area pdf of generating vertex i from vertex i-1 (0 for
        delta-sampled segments, remapped to 1 in ratios); light slot 0
        holds the emitter-area pdf.
    rat2: squared ratio (remap(pdf_rev(x_{i-1})) / remap(pfwd(x_{i-1})))^2
        linking slot i to slot i-1.  Slot 0 is unused.
    valid: 1.0 where the strategy cut between slot i-1 and i is
        connectable (both endpoints non-delta); light slot 0 is always 1.
    """

    pfwd: torch.Tensor
    rat2: torch.Tensor
    valid: torch.Tensor


class BDPTStats(NamedTuple):
    """Exact int64 counters (reference BvhStats analogs)."""

    rays_traced: torch.Tensor  # reference-parity (trace_path entries only)
    shadow_rays: torch.Tensor
    node_visits: torch.Tensor
    aabb_hits: torch.Tensor
    tri_tests: torch.Tensor
    tri_hits: torch.Tensor


def _remap0(x):
    """Veach remap: pdf 0 (delta) contributes ratio factor 1."""
    return torch.where(x > 0.0, x, 1.0)


def mis_strategy_table(info: MisInfo):
    """[S, S, B] table P[m, i] = valid[i] * prod_{q=i+1..m} rat2[q]: the
    junction-independent part of the power-heuristic term for moving the
    path cut from slot m down to slot i."""
    S, B = info.valid.shape
    rows = []
    prev = None
    for m in range(S):
        if m == 0:
            row = torch.zeros_like(info.valid)
        else:
            row = prev * info.rat2[m][None]
        row[m] = info.valid[m]
        rows.append(row)
        prev = row
    return torch.stack(rows)  # [S(m), S(i), B]


@contextmanager
def _highest_matmul():
    """float32 matmuls in full IEEE float32 (no TF32) inside the block: the
    power-heuristic weights are sums of products that TF32's 10-bit
    mantissa would bias."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _zero_stats(dev):
    z = torch.zeros((), dtype=torch.int64, device=dev)
    return BDPTStats(z, z, z, z, z, z)


def _empty_vertices(S, B, dtype, dev):
    def z(dt=dtype):
        return torch.zeros((S, B), dtype=dt, device=dev)

    return Vertices(
        valid=z(torch.bool), p=Vec3(z(), z(), z()), normal=Vec3(z(), z(), z()),
        wi=Vec3(z(), z(), z()), thr=Vec3(z(), z(), z()),
        emit=Vec3(z(), z(), z()), mat=z(torch.int64), u=z(), v=z(),
        delta=z(torch.bool), is_light=z(torch.bool),
    )


def _set(arr, b, mask, val):
    """arr[b] = mask ? val : arr[b], in place (the rows are this trace's
    own buffers)."""
    arr[b] = torch.where(mask, val, arr[b])


def _set3(vv: Vec3, b, mask, val: Vec3):
    for a, c in zip(vv, val):
        _set(a, b, mask, c)


def trace_subpath(scene: SceneTensors, o: Vec3, d: Vec3, thr0: Vec3, alive0,
                  steps: int, uniforms_fn, collect_background: bool,
                  mis_prev=None, plain: bool = False):
    """trace_path (camera.h:325-370) for ``steps`` bounces.

    Returns (Vertices [steps, B], background contribution Vec3 [B],
    BDPTStats[, MisInfo [steps, B]]).

    ``mis_prev`` (optional) enables per-vertex MIS pdf bookkeeping: a dict
    describing the vertex PRECEDING the first traced one — p, n (Vec3),
    delta (bool), mtype (int), pfwd (its own forward area pdf).  Every
    scattering pdf in the material set is independent of the incoming
    direction, so the reverse pdfs of interior vertices are fixed at trace
    time.  ``plain``: the closest hits walk the BVH in torch on any device.
    A bounce draws NT + V rows, the V free-flight draws of a volume scene
    last (bpt_tpu/models/bdpt.py:234-243)."""
    B = o.x.shape[0]
    dtype, dev = o.x.dtype, o.x.device
    verts = _empty_vertices(steps, B, dtype, dev)
    zeros = torch.zeros((B,), dtype=dtype, device=dev)
    bg_acc = Vec3(zeros, zeros, zeros)
    bg = Vec3(scene.background[0], scene.background[1], scene.background[2])
    stats = _zero_stats(dev)
    mis = None
    prev = None
    if mis_prev is not None:
        mis = MisInfo(*(torch.zeros((steps, B), dtype=dtype, device=dev)
                        for _ in range(3)))
        prev = (mis_prev["p"], mis_prev["n"], mis_prev["delta"],
                mis_prev["mtype"], mis_prev["pfwd"])
    thr, alive = thr0, alive0

    for b in range(steps):
        u = uniforms_fn(b, NT + scene.num_volumes)

        h = soa.closest_hit(scene, o, d, T_MIN, torch.inf, mask=alive, plain=plain)
        rec = soa.apply_volumes(scene, o, d, soa.complete_hit(scene, o, d, h), u[NT:], alive)[0]
        mtype = scene.materials.mtype[rec.mat]

        miss = alive & ~rec.hit
        if collect_background:
            bg_acc = v3.scale_add(bg_acc, miss, thr * bg)

        valid_v = alive & rec.hit
        delta = sh.is_delta(mtype)
        emission = sh.emitted(scene, rec.mat, rec.front_face, rec.u, rec.v, rec.p)
        wi = v3.normalize_safe(-d)

        _set(verts.valid, b, valid_v, True)
        _set3(verts.p, b, valid_v, rec.p)
        _set3(verts.normal, b, valid_v, rec.normal)
        _set3(verts.wi, b, valid_v, wi)
        _set3(verts.thr, b, valid_v, thr)
        _set3(verts.emit, b, valid_v, emission)
        _set(verts.mat, b, valid_v, rec.mat)
        _set(verts.u, b, valid_v, rec.u)
        _set(verts.v, b, valid_v, rec.v)
        _set(verts.delta, b, valid_v, delta)
        _set(verts.is_light, b, valid_v, mtype == MAT_LIGHT)

        if mis is not None:
            pp, pn, pdelta, pmtype, ppfwd = prev
            seg = Vec3(rec.p.x - pp.x, rec.p.y - pp.y, rec.p.z - pp.z)
            dist2 = torch.clamp_min(v3.length_squared(seg), 1e-30)
            du = v3.normalize_safe(seg)
            cos_cur = torch.abs(v3.dot(rec.normal, du))
            cos_prev = torch.abs(v3.dot(pn, du))
            # forward: the previous vertex's scattering pdf toward us
            pdf_sa_f = torch.where(pdelta, 0.0, sh.bsdf_pdf_value(pmtype, pn, du))
            pfwd_cur = pdf_sa_f * cos_cur / dist2
            # reverse: our scattering pdf back toward the previous vertex;
            # delta vertices give factor 1, a genuine zero stays 0
            prev_rev = torch.where(
                delta, 1.0,
                sh.bsdf_pdf_value(mtype, rec.normal, -du) * cos_prev / dist2)
            rat = prev_rev / _remap0(ppfwd)
            valid_cut = (~delta & ~pdelta).to(dtype)
            _set(mis.pfwd, b, valid_v, pfwd_cur)
            _set(mis.rat2, b, valid_v, rat * rat)
            _set(mis.valid, b, valid_v, valid_cut)
            prev = (
                v3.where(valid_v, rec.p, pp),
                v3.where(valid_v, rec.normal, pn),
                torch.where(valid_v, delta, pdelta),
                torch.where(valid_v, mtype, pmtype),
                torch.where(valid_v, pfwd_cur, ppfwd),
            )

        can_scatter = mtype != MAT_LIGHT
        atten = sh.attenuation(scene, rec.mat, mtype, rec.u, rec.v, rec.p)
        d_delta = sh.delta_scatter_dir(
            scene, rec.mat, mtype, d, rec.normal, rec.front_face,
            u[TU_DIEL], u[TU_FZ1], u[TU_FZ2])
        d_bsdf = sh.sample_bsdf_dir(mtype, rec.normal, u[TU_B1], u[TU_B2])
        pdf_val = sh.bsdf_pdf_value(mtype, rec.normal, d_bsdf)
        scat_pdf = sh.scattering_pdf(mtype, rec.normal, d_bsdf)

        delta_ok = valid_v & can_scatter & delta
        diff_ok = valid_v & can_scatter & ~delta & (pdf_val > 0.0)
        w = torch.where(pdf_val > 0.0,
                        scat_pdf / torch.where(pdf_val > 0.0, pdf_val, 1.0), 0.0)
        thr = v3.where(delta_ok, thr * atten,
                       v3.where(diff_ok, thr * atten * w, thr))
        alive_new = delta_ok | diff_ok
        o = v3.where(alive_new, rec.p, o)
        d = v3.where(alive_new, v3.where(delta_ok, d_delta, d_bsdf), d)

        stats = stats._replace(
            rays_traced=stats.rays_traced + alive.sum(dtype=torch.int64),
            node_visits=stats.node_visits + h.node_visits,
            aabb_hits=stats.aabb_hits + h.aabb_hits,
            tri_tests=stats.tri_tests + h.tri_tests,
            tri_hits=stats.tri_hits + h.tri_hits,
        )
        alive = alive_new

    if mis is not None:
        return verts, bg_acc, stats, mis
    return verts, bg_acc, stats


def build_light_subpath(scene: SceneTensors, B, max_depth: int, start_u,
                        uniforms_fn, dtype, mis: bool = False, plain: bool = False):
    """build_light_path (camera.h:372-418). start_u: NLS rows of [B].
    Returns (emitter Vertices [1, B], traced Vertices [max_depth-1, B],
    path_ok, BDPTStats[, MisInfo of the whole light path])."""
    s = sh.sample_surface(scene, start_u[LS_PICK], start_u[LS_U], start_u[LS_V])
    dev = s.position.x.device

    # emitter emission: forced front_face=true (camera.h:385-394)
    zeros = torch.zeros((B,), dtype=dtype, device=dev)
    # at uv = (0, 0) and the sampled point, as bpt_tpu/models/bdpt.py:694 does
    emission = sh.emitted(scene, s.mat, torch.ones((B,), dtype=torch.bool, device=dev),
                          zeros, zeros, s.position)
    path_ok = s.valid & (v3.length_squared(emission) > 0.0)

    inv_pdf = 1.0 / torch.clamp_min(s.pdf, 1e-8)
    thr0 = Vec3(inv_pdf, inv_pdf, inv_pdf)

    def slot(x):
        return x[None]

    def slot3(vv):
        return Vec3(*(slot(c) for c in vv))

    emitter = Vertices(
        valid=slot(path_ok), p=slot3(s.position), normal=slot3(s.normal),
        wi=slot3(s.normal),  # camera.h:401
        thr=slot3(thr0), emit=slot3(emission), mat=slot(s.mat),
        u=slot(zeros), v=slot(zeros),
        delta=slot(torch.zeros((B,), dtype=torch.bool, device=dev)),
        is_light=slot(path_ok),
    )

    # cosine exit (camera.h:407-415)
    dir_unit = v3.normalize_safe(
        sh.cosine_direction_world(s.normal, start_u[LS_D1], start_u[LS_D2]))
    cos_theta = torch.clamp_min(v3.dot(s.normal, dir_unit), 0.0)
    exit_ok = path_ok & (cos_theta > 0.0)
    pdf_dir = torch.clamp_min(cos_theta / sh.PI, 1e-8)
    scale = cos_theta / pdf_dir
    thr = Vec3(thr0.x * emission.x * scale, thr0.y * emission.y * scale,
               thr0.z * emission.z * scale)
    o = Vec3(s.position.x + 0.001 * s.normal.x,
             s.position.y + 0.001 * s.normal.y,
             s.position.z + 0.001 * s.normal.z)

    mis_prev = None
    if mis:
        mis_prev = dict(
            p=s.position, n=s.normal,
            delta=torch.zeros((B,), dtype=torch.bool, device=dev),
            mtype=scene.materials.mtype[s.mat],  # MAT_LIGHT: cos/pi exit pdf
            pfwd=s.pdf.to(dtype),
        )
    out = trace_subpath(scene, o, dir_unit, thr, exit_ok, max_depth - 1,
                        uniforms_fn, collect_background=False, mis_prev=mis_prev,
                        plain=plain)
    if mis:
        traced, _, stats, mis_tail = out
        ones = torch.ones((1, B), dtype=dtype, device=dev)
        mis_full = MisInfo(
            pfwd=torch.cat([s.pdf.to(dtype)[None], mis_tail.pfwd]),
            rat2=torch.cat([torch.zeros_like(ones), mis_tail.rat2]),
            valid=torch.cat([ones, mis_tail.valid]),  # area light
        )
        return emitter, traced, path_ok, stats, mis_full
    traced, _, stats = out
    return emitter, traced, path_ok, stats


def _concat_vertices(a: Vertices, b: Vertices) -> Vertices:
    def cat(x, y):
        if isinstance(x, Vec3):
            return Vec3(*(torch.cat([cx, cy]) for cx, cy in zip(x, y)))
        return torch.cat([x, y])

    return Vertices(*(cat(x, y) for x, y in zip(a, b)))


def connect_paths(scene: SceneTensors, cam: Vertices, light: Vertices,
                  mis_c: MisInfo = None, mis_l: MisInfo = None,
                  max_depth: int = 0, plain: bool = False, ref_vis: bool = False,
                  counts: bool = False):
    """All-pairs connect_vertices (camera.h:316-320, 440-475), one
    [S_l*B] shadow wave per camera slot.

    With mis_c/mis_l each (s, t) contribution is weighted by the power
    heuristic (beta=2) over every strategy of the same path length that
    the estimator realizes (a deviation from the reference, which sums all
    pairs unweighted; docs/PARITY.md).

    ``ref_vis`` emulates the reference binary's endpoint artifact
    (bpt_tpu/models/bdpt.py:850-887): the direction divides per component
    by the distance, as camera.h:429 does, and the shadow range ends
    exactly at the connection's endpoint (max_t, inclusive), where the
    endpoint's own surface lies; the rounding of its Möller–Trumbore t then
    decides whether the pair is visible.

    ``counts`` sums the shadow rays' walk counters (``soa.any_hit_counted``).

    Returns (radiance Vec3 [B], visible pairs int64, the shadow rays'
    int64[3] node visits, box hits and triangle tests; zeros unless
    ``counts``)."""
    S_c, B = cam.valid.shape
    S_l = light.valid.shape[0]
    dtype, dev = cam.p.x.dtype, cam.p.x.device
    mis = mis_c is not None
    if mis:
        P_c = mis_strategy_table(mis_c)  # [S_c, S_c, B]
        P_l = mis_strategy_table(mis_l)  # [S_l, S_l, B]
        lmt_all = scene.materials.mtype[light.mat]
        n_idx = torch.arange(S_l, device=dev)
        i_idx = torch.arange(S_c, device=dev)

    # light-side factors, independent of s
    lmtype = scene.materials.mtype[light.mat]
    f_light_bsdf = sh.evaluate_bsdf(scene, light.mat, lmtype, light.u, light.v, light.p)
    # emitter vertices use raw emission as their "BSDF" (camera.h:462-467)
    f_light = v3.where(light.is_light, light.emit, f_light_bsdf)
    light_factor = light.thr * f_light  # [S_l, B]
    light_ok = light.valid & ~light.delta & (v3.length_squared(f_light) > 0.0)

    zeros = torch.zeros((B,), dtype=dtype, device=dev)
    total = Vec3(zeros, zeros, zeros)
    n_shadow = torch.zeros((), dtype=torch.int64, device=dev)
    shadow_walk = torch.zeros(3, dtype=torch.int64, device=dev)
    for s in range(S_c):
        cp, cn, cthr = _row3(cam.p, s), _row3(cam.normal, s), _row3(cam.thr, s)
        cmat = cam.mat[s]
        c_ok = cam.valid[s] & ~cam.delta[s]
        cmtype = scene.materials.mtype[cmat]
        f_cam = sh.evaluate_bsdf(scene, cmat, cmtype, cam.u[s], cam.v[s], cp)  # [B]
        c_ok = c_ok & (v3.length_squared(f_cam) > 0.0)
        cam_factor = cthr * f_cam

        # cam row against every light slot: [S_l, B]
        diff = Vec3(light.p.x - cp.x[None], light.p.y - cp.y[None],
                    light.p.z - cp.z[None])
        dist2 = v3.length_squared(diff)
        pair_ok = c_ok[None] & light_ok & (dist2 > 0.0)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
        if ref_vis:
            du = Vec3(diff.x / dist, diff.y / dist, diff.z / dist)
        else:
            inv_dist = 1.0 / dist
            du = Vec3(diff.x * inv_dist, diff.y * inv_dist, diff.z * inv_dist)
        sgn_cam = du.x * cn.x[None] + du.y * cn.y[None] + du.z * cn.z[None]
        sgn_light = v3.dot(light.normal, -du)
        cos_cam = torch.abs(sgn_cam)
        cos_light = torch.abs(sgn_light)
        pair_ok = pair_ok & (cos_cam > 0.0) & (cos_light > 0.0)
        if mis:
            # one-sided connections: the reference's abs() cosines carry
            # light through the back of one-sided lambertian surfaces,
            # paths no forward strategy samples; isotropic scatterers stay
            # two-sided, matching their spherical pdf
            pair_ok = pair_ok & ((cmtype == MAT_ISOTROPIC)[None] | (sgn_cam > 0.0))
            pair_ok = pair_ok & ((lmt_all == MAT_ISOTROPIC) | (sgn_light > 0.0))

        # visible(a, b) (camera.h:425-438) with the endpoint margin
        max_t = dist - 0.001
        pair_ok = pair_ok & (max_t > 0.0)
        so = Vec3(cp.x[None] + 0.001 * du.x, cp.y[None] + 0.001 * du.y,
                  cp.z[None] + 0.001 * du.z)
        t_vis = max_t if ref_vis else max_t * (1.0 - SHADOW_EPS_REL)

        g = (cos_cam * cos_light) / torch.clamp_min(dist2, 1e-30)
        contrib = Vec3(cam_factor.x[None] * light_factor.x * g,
                       cam_factor.y[None] * light_factor.y * g,
                       cam_factor.z[None] * light_factor.z * g)
        if mis:
            d2s = torch.clamp_min(dist2, 1e-30)
            # reverse pdf of the camera junction vertex: the light
            # junction's scattering pdf toward it, area measure
            rev_c = torch.where(
                light.delta, 0.0, sh.bsdf_pdf_value(lmt_all, light.normal, -du)
            ) * cos_cam / d2s
            # reverse pdf of the light junction vertex: the camera
            # junction's scattering pdf toward it
            cn_b = Vec3(cn.x[None], cn.y[None], cn.z[None])
            rev_l = torch.where(
                cam.delta[s][None], 0.0, sh.bsdf_pdf_value(cmtype[None], cn_b, du)
            ) * cos_light / d2s
            # junction endpoints are non-delta wherever the pair
            # contributes: zero reverse pdfs are genuine and not remapped
            rc_ratio = rev_c / _remap0(mis_c.pfwd[s])[None]
            rl_ratio = rev_l / _remap0(mis_l.pfwd)
            # realizability clamp: strategies keeping i camera vertices
            # need the light side k - i <= max_depth, k = (s+1) + (n+1)
            k_tot = s + n_idx + 2  # [S_l]
            cmask = (i_idx[None, :] >= (k_tot - max_depth)[:, None]).to(dtype)
            lmask = ((n_idx[None, :] >= (k_tot - max_depth)[:, None])
                     & (n_idx[None, :] <= n_idx[:, None])).to(dtype)
            with _highest_matmul():
                sum_c = rc_ratio * rc_ratio * torch.einsum("ni,ib->nb", cmask, P_c[s])
                sum_l = rl_ratio * rl_ratio * torch.einsum("nj,njb->nb", lmask, P_l)
            w_mis = 1.0 / (1.0 + sum_c + sum_l)
            contrib = Vec3(contrib.x * w_mis, contrib.y * w_mis, contrib.z * w_mis)

        shadow = (Vec3(*(c.reshape(-1) for c in so)), Vec3(*(c.reshape(-1) for c in du)),
                  T_MIN, t_vis.reshape(-1))
        if counts:
            occluded, walk = soa.any_hit_counted(scene, *shadow, mask=pair_ok.reshape(-1),
                                                 plain=plain)
            shadow_walk = shadow_walk + walk
        else:
            occluded = soa.any_hit(scene, *shadow, mask=pair_ok.reshape(-1), plain=plain)
        pair_ok = pair_ok & ~occluded.reshape(S_l, B)
        total = Vec3(*(acc + torch.where(pair_ok, c, 0.0).sum(dim=0)
                       for acc, c in zip(total, contrib)))
        n_shadow = n_shadow + pair_ok.sum(dtype=torch.int64)
    return total, n_shadow, shadow_walk


def _row3(vv: Vec3, s) -> Vec3:
    return Vec3(vv.x[s], vv.y[s], vv.z[s])


def bdpt_radiance(scene: SceneTensors, origins, dirs, max_depth: int,
                  cam_uniforms_fn, light_start_u, light_uniforms_fn,
                  mis: bool = False, ref_vis: bool = False,
                  count_shadow_tests: bool = False, plain: bool = False):
    """bidirectional_color (camera.h:294-323) for a batch of primary rays.
    origins/dirs: [B,3].  light_start_u: [B, NLS] or NLS rows of [B].

    ``mis`` switches on power-heuristic MIS over the (s, t) strategies
    (not in the reference, which sums all pairs unweighted).
    ``ref_vis``: the reference binary's shadow-endpoint artifact
    (``connect_paths``).  ``count_shadow_tests`` adds the shadow rays' node
    visits, box hits and triangle tests to the counters, as the megakernel
    counts them (T triangle tests a pair that reaches the any-hit test on a
    scene without a BVH); off, the stats equal ``bpt_tpu``'s wavefront,
    which leaves them out.  ``plain`` runs the hits' torch versions on any
    device.

    Returns (radiance [B,3], BDPTStats)."""
    B = origins.shape[0]
    dtype, dev = origins.dtype, origins.device
    o0 = v3.from_array(origins)
    d0 = v3.from_array(dirs)
    ones = torch.ones((B,), dtype=dtype, device=dev)
    if not isinstance(light_start_u, (list, tuple)):
        light_start_u = [light_start_u[:, i] for i in range(NLS)]

    mis_prev_cam = None
    if mis:
        mis_prev_cam = dict(
            p=o0, n=v3.normalize_safe(d0),
            delta=torch.ones((B,), dtype=torch.bool, device=dev),  # pfwd -> remap 1
            mtype=torch.zeros((B,), dtype=torch.int64, device=dev),
            pfwd=ones,
        )
    cam_out = trace_subpath(scene, o0, d0, Vec3(ones, ones, ones),
                            torch.ones((B,), dtype=torch.bool, device=dev),
                            max_depth, cam_uniforms_fn, collect_background=True,
                            mis_prev=mis_prev_cam, plain=plain)
    if mis:
        cam, bg_acc, stats_c, mis_c = cam_out
    else:
        cam, bg_acc, stats_c = cam_out
        mis_c = None

    # camera-vertex emission (camera.h:305-309); strategy (s=0, t) under MIS
    emit_mask = cam.valid & ~cam.delta
    ve = cam.thr * cam.emit
    ve = Vec3(*(torch.where(emit_mask, c, 0.0) for c in ve))
    if mis:
        # reverse pdf of the emitting vertex under the s>=1 strategies: the
        # emitter-area pdf of sample_surface (1/total_area on any light)
        total = scene.light_total_area
        inv_area = torch.where(total > 0.0, 1.0 / torch.clamp_min(total, 1e-30),
                               0.0).to(dtype)
        sums = mis_strategy_table(mis_c).sum(dim=1)  # [S, B]; k = m+1 <= D
        r_em = inv_area / _remap0(mis_c.pfwd)
        w_em = 1.0 / (1.0 + r_em * r_em * sums)
        ve = Vec3(ve.x * w_em, ve.y * w_em, ve.z * w_em)
    result = Vec3(*(a + c.sum(dim=0) for a, c in zip(bg_acc, ve)))

    light_out = build_light_subpath(scene, B, max_depth, light_start_u,
                                    light_uniforms_fn, dtype, mis=mis, plain=plain)
    if mis:
        emitter, traced, _, stats_l, mis_l = light_out
    else:
        emitter, traced, _, stats_l = light_out
        mis_l = None
    light = _concat_vertices(emitter, traced) if max_depth > 1 else emitter

    connect, n_shadow, sw = connect_paths(
        scene, cam, light, mis_c=mis_c, mis_l=mis_l, max_depth=max_depth, plain=plain,
        ref_vis=ref_vis, counts=count_shadow_tests)
    result = Vec3(*(a + c for a, c in zip(result, connect)))

    stats = BDPTStats(
        rays_traced=stats_c.rays_traced + stats_l.rays_traced,
        shadow_rays=n_shadow,
        node_visits=stats_c.node_visits + stats_l.node_visits + sw[0],
        aabb_hits=stats_c.aabb_hits + stats_l.aabb_hits + sw[1],
        tri_tests=stats_c.tri_tests + stats_l.tri_tests + sw[2],
        tri_hits=stats_c.tri_hits + stats_l.tri_hits,
    )
    return v3.to_array(result), stats


def _megakernel_ok(scene: SceneTensors) -> bool:
    """A CUDA scene the BDPT megakernel takes (bpt_tpu's TPU dispatch)."""
    from bpt_tpu_torch.ops.kernels.pt_kernel import megakernel_reject_reason

    return scene.device.type == "cuda" and not megakernel_reject_reason(scene, "bdpt")


def bdpt_fast(scene: SceneTensors, origins, dirs, ray_ids, key, max_depth: int,
              mis: bool = False, ref_vis: bool = False, plain: bool = False):
    """``bpt_tpu.models.bdpt.bdpt_fast`` (bdpt.py:1005-1055): one BDPT
    sample of each primary ray.  ``key`` is the render key; ray_ids [B]
    int, negative = inactive (a zero radiance).

    Dispatch: on a CUDA scene the estimators follow ``bpt_tpu``'s TPU
    dispatch, on a CPU scene its CPU dispatch.  So a CUDA scene that the
    megakernel takes (``megakernel_reject_reason``: a small scene, or one
    with a BVH, which it walks) launches ``bdpt_megakernel`` in rays mode
    on its own stream (streams 2/3/4 fold inside), unless ``ref_vis``;
    everything else runs ``bdpt_jnp``.  ``plain`` keeps those branches and
    swaps every kernel for its plain version.

    Returns (radiance [B,3], BDPTStats)."""
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk  # imports this module

    if not ref_vis and _megakernel_ok(scene):
        launch = bk.bdpt_megakernel_plain if plain else bk.bdpt_megakernel
        rx, ry, rz, rays, shadow, extra = launch(
            scene, Vec3(*origins.unbind(1)), Vec3(*dirs.unbind(1)), ray_ids, key,
            max_depth, mis=mis)
        return torch.stack([rx, ry, rz], dim=-1), BDPTStats(rays, shadow, *extra)
    return bdpt_jnp(scene, origins, dirs, ray_ids, key, max_depth, mis=mis,
                    ref_vis=ref_vis, plain=plain)


def bdpt_jnp(scene: SceneTensors, origins, dirs, ray_ids, key, max_depth: int,
             mis: bool = False, ref_vis: bool = False, plain: bool = False):
    """The jnp branch of ``bdpt_fast``, and the estimator of ``bpt_tpu``'s
    BDPT wave loop (``_make_step_bdpt_wave``): ``bdpt_radiance`` on the jnp
    stream.  The camera trace draws from ``fold_in(key, 2)``, the light
    start from ``fold_in(key, 3)`` (one ``wave_uniforms`` call of NLS
    draws at bounce 0) and the light trace from ``fold_in(key, 4)``, each
    keyed by the absolute ray id (an inactive lane still traces, as in
    ``bpt_tpu``), its hits on the CUDA hit kernels of a CUDA scene;
    ``plain`` swaps them for their plain versions.

    Returns (radiance [B,3], BDPTStats)."""
    active = ray_ids >= 0
    ids = torch.clamp_min(ray_ids, 0)
    dtype = origins.dtype
    ls_u = rng.uniform_rows(rng.fold_in(key, 3), ids, 0, NLS, dtype)
    rad, stats = bdpt_radiance(
        scene, origins, dirs, max_depth,
        default_uniforms_fn(rng.fold_in(key, 2), ids, dtype), ls_u,
        default_uniforms_fn(rng.fold_in(key, 4), ids, dtype),
        mis=mis, ref_vis=ref_vis, plain=plain)
    return torch.where(active[:, None], rad, 0.0), stats
