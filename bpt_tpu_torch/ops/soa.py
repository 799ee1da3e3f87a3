"""SoA intersection over component tensors.

Counterpart of ``bpt_tpu.ops.soa``'s brute-force and BVH hits: every
ray against every triangle as one [T, B] broadcast (``brute_closest``,
``brute_any``), with the reference's epsilon and comparison order
(triangle.h:41-74) and first-hit-wins on exact t ties; and the batched
threaded-DFS traversals ``bvh_closest`` and ``bvh_any``.  These are the
plain versions of the CUDA kernels ``ops/kernels/intersect.py::
closest_tri`` / ``any_tri`` and ``ops/kernels/pt_wave.py::closest_bvh`` /
``any_bvh``.

Dispatch (``closest_hit``, ``any_hit``), as bpt_tpu's (soa.py:534-644): a
scene without a BVH sweeps every triangle; a scene with one (``scene.
use_bvh``) on the card takes bpt_tpu's TPU route (``wave_impl``): the BVH
walks ``closest_bvh`` / ``any_bvh`` over the production interval, the
clustered kernels of ``ops/kernels/cluster_wave.py`` over any other or with
``BPT_TPU_NO_FTB``, those of ``ops/kernels/plucker.py`` with
``BPT_TPU_WAVE_IMPL=plucker``; in float64, where bpt_tpu walks the BVH in
jnp for every interval, the float64 ``closest_bvh`` / ``any_bvh`` for
every interval, whatever the switches; on a CPU it walks the BVH in torch,
as bpt_tpu does there.  On a CUDA scene the calls launch the kernels (a
failure raises; nothing falls back); ``plain`` runs their torch versions on
the card, for comparisons.

Volumes (bpt_tpu/ops/soa.py:823-905): ``volume_interaction`` and
``apply_volumes`` override a hit record where a constant-density volume's
free flight ends before the surface; they are the plain version of the
kernels' override (``csrc/volume.cuh``).
"""

from __future__ import annotations

import numbers
import os
from typing import NamedTuple

import torch

from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops.intersect import MT_EPSILON, T_MIN
from bpt_tpu_torch.scene.types import SceneTensors


class HitSoA(NamedTuple):
    hit: torch.Tensor  # [B] bool
    t: torch.Tensor  # [B] (inf when miss)
    tri: torch.Tensor  # [B] int64
    u: torch.Tensor  # [B]
    v: torch.Tensor  # [B]
    # reference BvhStats counters, summed over the wave (int64 scalars)
    node_visits: torch.Tensor
    aabb_hits: torch.Tensor
    tri_tests: torch.Tensor
    tri_hits: torch.Tensor


def _mt_valid(det, t, u, v, tmin, tmax):
    return (
        (torch.abs(det) >= MT_EPSILON)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin) & (t <= tmax)
    )


def _mt_all(v0a, e1a, e2a, o: Vec3, d: Vec3):
    """Möller–Trumbore of every ray against every triangle as one [T, B]
    broadcast.  Returns (det, t, u, v), each [T, B]."""
    dx, dy, dz = d.x[None], d.y[None], d.z[None]  # [1,B]
    ox, oy, oz = o.x[None], o.y[None], o.z[None]
    e2x, e2y, e2z = e2a[:, 0:1], e2a[:, 1:2], e2a[:, 2:3]  # [T,1]
    e1x, e1y, e1z = e1a[:, 0:1], e1a[:, 1:2], e1a[:, 2:3]
    v0x, v0y, v0z = v0a[:, 0:1], v0a[:, 1:2], v0a[:, 2:3]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / det
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return det, t, u, v


def brute_closest(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax) -> HitSoA:
    """Closest hit over all triangles; argmin over T (first hit wins on
    exact ties).  tmin/tmax: [B]."""
    T = scene.num_tris
    det, t, u, v = _mt_all(scene.v0, scene.e1, scene.e2, o, d)
    valid = _mt_valid(det, t, u, v, tmin[None], tmax[None])
    t_masked = torch.where(valid, t, torch.inf)
    tri = torch.argmin(t_masked, dim=0)  # [B]
    t_best = torch.gather(t_masked, 0, tri[None])[0]
    hit = torch.isfinite(t_best)
    B = o.x.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=o.x.device)
    return HitSoA(
        hit=hit, t=t_best, tri=tri,
        u=torch.gather(u, 0, tri[None])[0],
        v=torch.gather(v, 0, tri[None])[0],
        node_visits=zero, aabb_hits=zero,
        tri_tests=torch.tensor(T * B, dtype=torch.int64, device=o.x.device),
        tri_hits=hit.sum(dtype=torch.int64),
    )


def _mt_lanes(v0: Vec3, e1: Vec3, e2: Vec3, o: Vec3, d: Vec3):
    """Möller–Trumbore of each ray against its own triangle (bpt_tpu's
    _mt_one).  Returns (det, t, u, v)."""
    pvec = v3.cross(d, e2)
    det = v3.dot(e1, pvec)
    inv = 1.0 / det
    tvec = o - v0
    u = v3.dot(tvec, pvec) * inv
    qvec = v3.cross(tvec, e1)
    v = v3.dot(d, qvec) * inv
    t = v3.dot(e2, qvec) * inv
    return det, t, u, v


def _nan_to(val, x):
    return torch.where(torch.isnan(x), val, x)


def _bvh_walk(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax, mask,
              any_hit: bool):
    """The batched threaded-DFS walk behind ``bvh_closest`` and ``bvh_any``.
    Returns (t_best, tri (-1 on a miss), u, v, counters int64[4])."""
    N = int(scene.bvh_skip.shape[0])
    T = scene.num_tris
    B = o.x.shape[0]
    dtype, dev = o.x.dtype, o.x.device
    kw = dict(dtype=dtype, device=dev)
    skip = scene.bvh_skip.long()
    first = scene.bvh_first.long()
    count = scene.bvh_count.long()
    inf = torch.tensor(torch.inf, **kw)

    # the working set: lane ids `ws`, their rays and traversal state
    ws = torch.arange(B, device=dev)
    org = torch.stack([o.x, o.y, o.z], dim=1)
    dirs = torch.stack([d.x, d.y, d.z], dim=1)
    inv = 1.0 / dirs
    lo = torch.broadcast_to(torch.as_tensor(tmin, **kw), (B,))
    t_best = torch.broadcast_to(torch.as_tensor(tmax, **kw), (B,)).clone()
    if mask is not None:
        t_best = torch.where(mask, t_best, 0.0)
    i = torch.zeros(B, dtype=torch.int64, device=dev)
    if any_hit:  # a dead lane (tmax <= 0) never reaches the root
        i = torch.where(t_best > 0.0, i, N)
    tri = torch.full((B,), -1, dtype=torch.int64, device=dev)
    ub = torch.zeros(B, **kw)
    vb = torch.zeros(B, **kw)
    out = [t_best.clone(), tri.clone(), ub.clone(), vb.clone()]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    nv, ah, tt, th = zero, zero, zero, zero

    step = 0
    while True:
        if step % 8 == 0:  # retire finished lanes (one host sync per 8 steps)
            keep = i < N
            done = ~keep
            for dst, src in zip(out, (t_best, tri, ub, vb)):
                dst[ws[done]] = src[done]
            ws, org, dirs, inv, lo, t_best, i, tri, ub, vb = (
                x[keep] for x in (ws, org, dirs, inv, lo, t_best, i, tri, ub, vb))
            if not ws.numel():
                break
        active = i < N
        ic = torch.clamp_max(i, N - 1)
        t0 = (scene.bvh_min[ic] - org) * inv
        t1 = (scene.bvh_max[ic] - org) * inv
        # min / max of the three axes are exact in any order
        enter = torch.maximum(_nan_to(-inf, torch.minimum(t0, t1)).amax(dim=1), lo)
        exit_ = torch.minimum(_nan_to(inf, torch.maximum(t0, t1)).amin(dim=1), t_best)
        box_hit = (exit_ > enter) & active
        cnt = count[ic]
        is_leaf = cnt > 0
        do_leaf = box_hit & is_leaf
        # both leaf slots at once ([2, n]), accepted in order
        ti = torch.clamp_max(first[ic] + torch.arange(2, device=dev)[:, None], T - 1)
        det, t, u, v = _mt_lanes(*(v3.gather(a, ti) for a in (scene.v0, scene.e1, scene.e2)),
                                 Vec3(*org.T[:, None]), Vec3(*dirs.T[:, None]))
        for k in range(2):
            test = do_leaf & (cnt > k)
            ok = test & _mt_valid(det[k], t[k], u[k], v[k], lo, t_best)
            tt = tt + test.sum(dtype=torch.int64)
            th = th + ok.sum(dtype=torch.int64)
            tri = torch.where(ok, ti[k], tri)
            if not any_hit:  # the closest hit shrinks the interval
                t_best = torch.where(ok, t[k], t_best)
                ub = torch.where(ok, u[k], ub)
                vb = torch.where(ok, v[k], vb)
        nv = nv + active.sum(dtype=torch.int64)
        ah = ah + box_hit.sum(dtype=torch.int64)
        i = torch.where(active, torch.where(box_hit & ~is_leaf, ic + 1, skip[ic]), i)
        if any_hit:  # a hit in the leaf ends the walk
            i = torch.where(tri >= 0, N, i)
        step += 1
    if mask is not None and not any_hit:
        nv = nv - (~mask).sum(dtype=torch.int64)
    return (*out, torch.stack([nv, ah, tt, th]))


def bvh_closest(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax,
                mask=None) -> HitSoA:
    """Batched threaded-DFS traversal (bpt_tpu/ops/soa.py:135-233; the
    visit order and t-shrink of bvh_node::hit, src/acceleration/bvh.h:50-59):
    an AABB hit at internal node i continues to i+1, a miss or a leaf
    jumps to skip[i]; a leaf tests its 1-2 triangles in order and replaces
    the best hit on ``t <= t_best`` (the reference's interval.contains).
    NaN slab terms (origin on a slab plane, zero direction component)
    leave that axis unconstrained.  tmin, tmax: scalars or [B].  mask:
    optional [B] bool; lanes with mask=False are misses that count nothing
    (their tmax collapses to 0: they visit the root once and miss it,
    and that visit is taken off again).

    Counters: node visits, AABB hits, triangle tests and accepted
    triangle tests (replacements), summed over the lanes.  Lanes that
    have finished drop out of the working set every few steps; that
    changes no lane's visits.  The plain version of the CUDA walks; counts
    its calls in ``bvh_closest.calls``."""
    bvh_closest.calls += 1
    t_best, tri, ub, vb, c = _bvh_walk(scene, o, d, tmin, tmax, mask, any_hit=False)
    hit = tri >= 0
    return HitSoA(
        hit=hit, t=torch.where(hit, t_best, torch.inf), tri=torch.clamp_min(tri, 0),
        u=ub, v=vb, node_visits=c[0], aabb_hits=c[1], tri_tests=c[2], tri_hits=c[3],
    )


bvh_closest.calls = 0


def bvh_any(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Batched any-hit traversal over [tmin, tmax] (bpt_tpu/ops/soa.py:
    240-306): ``bvh_closest``'s walk, NaN slab rules and triangle test with
    a fixed tmax; a leaf tests all its triangles and a hit among them ends
    the lane's walk.  A lane with tmax <= 0 (a masked shadow ray) is dead:
    it misses without visiting the root.  tmin, tmax: scalars or [B].

    Returns (hit [B] bool, counters int64[4] = node visits, AABB hits,
    triangle tests, accepted tests), the counters for the kernel's checks
    and bound only.  The plain version of the CUDA ``any_bvh``; counts its
    calls in ``bvh_any.calls``."""
    bvh_any.calls += 1
    _, tri, _, _, c = _bvh_walk(scene, o, d, tmin, tmax, None, any_hit=True)
    return tri >= 0, c


bvh_any.calls = 0


def brute_any(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Any-hit over all triangles: bool [B]."""
    det, t, u, v = _mt_all(scene.v0, scene.e1, scene.e2, o, d)
    return torch.any(_mt_valid(det, t, u, v, tmin[None], tmax[None]), dim=0)


def _bounds(o: Vec3, tmin, tmax, mask):
    B = o.x.shape[0]
    kw = dict(dtype=o.x.dtype, device=o.x.device)
    tmin_b = torch.broadcast_to(torch.as_tensor(tmin, **kw), (B,))
    tmax_b = torch.broadcast_to(torch.as_tensor(tmax, **kw), (B,))
    if mask is not None:
        tmax_b = torch.where(mask, tmax_b, 0.0)
    return tmin_b, tmax_b


def _card_bvh(scene: SceneTensors) -> bool:
    """A scene with a BVH on the card takes ``bpt_tpu``'s TPU dispatch
    (``wave_impl``); on a CPU it walks the BVH in torch, as ``bpt_tpu``
    does there (its clustered route requires the TPU, soa.py:344-362)."""
    return scene.use_bvh and scene.device.type == "cuda"


def _kernel_route(scene: SceneTensors, plain: bool) -> bool:
    """Hit calls of such a scene launch the CUDA kernels; ``plain`` runs
    their plain versions on the card instead, for comparisons only."""
    return _card_bvh(scene) and not plain


def _is_static(x, val: float) -> bool:
    """x is a Python number equal to val (bpt_tpu's _is_static: a
    per-lane tensor is never the production interval)."""
    return isinstance(x, numbers.Real) and float(x) == val


def wave_impl(tmin, tmax=None, dtype=torch.float32) -> str:
    """The hit kernels ``bpt_tpu`` takes for a large scene on its TPU
    (soa.py:410-427, 472-475, 544-551, 599-601), by its own switches, read
    here at call time and nowhere else:
    - ``"bvh64"``: float64, any interval, whatever the switches: ``bpt_tpu``'s
      clustered route takes float32 only (``_wave_cluster_ok``), so a float64
      hit walks the BVH (its jnp ``bvh_closest`` / ``bvh_any``), here the
      float64 instantiations of ``closest_bvh`` / ``any_bvh``, unsorted;
    - ``"bvh"``: the production interval, (T_MIN, inf) for a closest hit
      (``tmax`` given) and tmin = T_MIN for an any hit (``tmax`` None),
      with neither switch set: the FTB kernels 7 and 8, ported as
      ``closest_bvh`` / ``any_bvh``;
    - ``"roll"``: any other interval, or ``BPT_TPU_NO_FTB`` set: kernels 10
      and 11, ``clustered_closest`` / ``clustered_any``;
    - ``"plucker"``: ``BPT_TPU_WAVE_IMPL=plucker``, any interval: kernels 12
      and 13, ``plucker_closest`` / ``plucker_any``."""
    if dtype == torch.float64:
        return "bvh64"
    impl = os.environ.get("BPT_TPU_WAVE_IMPL", "roll")
    if impl == "plucker":
        return "plucker"
    production = _is_static(tmin, T_MIN) and (tmax is None or _is_static(tmax, torch.inf))
    if production and impl == "roll" and os.environ.get("BPT_TPU_NO_FTB", "") == "":
        return "bvh"
    return "roll"


def _sweeps(plain: bool):
    """(closest, any) sweeps of a scene without a BVH: the CUDA kernels of
    ``ops/kernels/intersect.py`` (their plain versions on CPU tensors), or
    the plain versions themselves when ``plain``."""
    from bpt_tpu_torch.ops.kernels import intersect as ki  # imports soa

    if plain:
        return ki.closest_tri_plain, ki.any_tri_plain
    return ki.closest_tri, ki.any_tri


def _clustered(scene: SceneTensors, o: Vec3, d: Vec3, tmin_b, tmax_b, mask,
               impl: str, kernels: bool, any_hit: bool):
    """The clustered route (``bpt_tpu``'s _clustered_sorted_closest and
    any_hit, soa.py:385-407, 505-516, 612-633): the lanes sorted by
    ``morton_octant_key`` over the root box, the lanes the mask leaves out
    last; the kernel (``kernels``) or its plain version over [tmin_b,
    tmax_b]; the answers back in lane order.  The sort changes no lane's
    answer.  Returns the kernel's outputs but its counters."""
    from bpt_tpu_torch.ops.kernels import cluster_wave as cw  # imports soa
    from bpt_tpu_torch.ops.kernels import plucker as kp

    kernel, plain = {
        ("roll", False): (cw.clustered_closest, cw.clustered_closest_plain),
        ("roll", True): (cw.clustered_any, cw.clustered_any_plain),
        ("plucker", False): (kp.plucker_closest, kp.plucker_closest_plain),
        ("plucker", True): (kp.plucker_any, kp.plucker_any_plain),
    }[impl, any_hit]
    fn = kernel if kernels else plain
    f32 = torch.float32
    key = cw.morton_octant_key(scene.bvh_min[0].to(f32), scene.bvh_max[0].to(f32),
                               *(c.to(f32) for c in (*o, *d)))
    if mask is not None:
        key = torch.where(mask, key, 0x7FFFFFFF)
    perm = torch.sort(key, stable=True).indices
    out = fn(scene, Vec3(*(c[perm] for c in o)), Vec3(*(c[perm] for c in d)),
             tmin_b[perm], tmax_b[perm])[:-1]
    back = []
    for x in out:
        y = torch.empty_like(x)
        y[perm] = x
        back.append(y)
    return back


def _live(o: Vec3, mask):
    return o.x.shape[0] if mask is None else mask.sum(dtype=torch.int64)


def closest_hit(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax,
                mask=None, plain: bool = False) -> HitSoA:
    """mask: optional [B] bool — lanes with mask=False are culled (tmax
    collapses to 0) and excluded from the stats counters.  A CUDA scene
    with a BVH takes the kernels ``wave_impl`` names: ``closest_bvh`` over
    the production interval and, in float64, over any; ``clustered_closest``
    / ``plucker_closest`` over any [tmin, tmax] in float32; one without
    launches ``closest_tri``; ``plain`` runs their plain versions.  A CPU
    scene walks ``bvh_closest`` or sweeps in torch.  Counters of a sweep and
    of the clustered route (bpt_tpu's, soa.py:524-531): T triangle tests per
    live lane, one accepted test per hit."""
    zero = torch.zeros((), dtype=torch.int64, device=o.x.device)
    if _card_bvh(scene):
        impl = wave_impl(tmin, tmax, scene.dtype)
        kernels = _kernel_route(scene, plain)
        if impl in ("bvh", "bvh64") and kernels:
            from bpt_tpu_torch.ops.kernels.pt_wave import closest_bvh  # imports soa

            active = (torch.ones(o.x.shape, dtype=torch.bool, device=o.x.device)
                      if mask is None else mask)
            t, tri, u, v, c = closest_bvh(scene, o, d, active, tmin, tmax)
            hit = tri >= 0
            return HitSoA(hit=hit, t=t, tri=torch.clamp_min(tri, 0).long(), u=u, v=v,
                          node_visits=c[0], aabb_hits=c[1], tri_tests=c[2], tri_hits=c[3])
        if impl in ("roll", "plucker"):
            t, tri, u, v = _clustered(scene, o, d, *_bounds(o, tmin, tmax, mask), mask,
                                      impl, kernels, any_hit=False)
            hit = tri >= 0
            return HitSoA(hit=hit, t=t, tri=torch.clamp_min(tri, 0).long(), u=u, v=v,
                          node_visits=zero, aabb_hits=zero,
                          tri_tests=torch.as_tensor(_live(o, mask) * scene.num_tris,
                                                    device=o.x.device),
                          tri_hits=hit.sum(dtype=torch.int64))
    if scene.use_bvh:
        return bvh_closest(scene, o, d, tmin, tmax, mask)
    tmin_b, tmax_b = _bounds(o, tmin, tmax, mask)
    t, tri, u, v = _sweeps(plain)[0](scene, o, d, tmin_b, tmax_b)
    hit = tri >= 0  # a culled lane (tmax 0 < T_MIN) never hits
    return HitSoA(hit=hit, t=t, tri=torch.clamp_min(tri, 0).long(), u=u, v=v,
                  node_visits=zero, aabb_hits=zero,
                  tri_tests=torch.as_tensor(_live(o, mask) * scene.num_tris, device=o.x.device),
                  tri_hits=hit.sum(dtype=torch.int64))


def _any_hit(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax, mask, plain: bool):
    """(hit [B] bool, the walk's counters int64[4], or None for a sweep and
    the clustered route)."""
    tmin_b, tmax_b = _bounds(o, tmin, tmax, mask)
    if _card_bvh(scene):
        impl = wave_impl(tmin, dtype=scene.dtype)
        kernels = _kernel_route(scene, plain)
        if impl in ("bvh", "bvh64") and kernels:
            from bpt_tpu_torch.ops.kernels.pt_wave import any_bvh  # imports soa

            return any_bvh(scene, o, d, tmax_b, tmin)
        if impl in ("roll", "plucker"):
            return _clustered(scene, o, d, tmin_b, tmax_b, mask, impl, kernels,
                              any_hit=True)[0], None
    if scene.use_bvh:
        return bvh_any(scene, o, d, tmin_b, tmax_b)
    return _sweeps(plain)[1](scene, o, d, tmin_b, tmax_b), None


def any_hit(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax, mask=None,
            plain: bool = False):
    """bool [B]: a hit in [tmin, tmax]; lanes with mask=False miss.  A
    CUDA scene with a BVH takes the kernels ``wave_impl`` names: ``any_bvh``
    for tmin = T_MIN and, in float64, for any tmin; ``clustered_any`` /
    ``plucker_any`` for any tmin in float32; one
    without launches ``any_tri``; ``plain`` runs their plain versions.  A
    CPU scene walks ``bvh_any`` or sweeps every triangle in torch."""
    return _any_hit(scene, o, d, tmin, tmax, mask, plain)[0]


def any_hit_counted(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax, mask=None,
                    plain: bool = False):
    """``any_hit`` and int64[3] = (node visits, box hits, triangle tests)
    of these shadow rays as the megakernels count them: the walks' own, or
    T tests a live lane of a sweep and of the clustered route."""
    hit, c = _any_hit(scene, o, d, tmin, tmax, mask, plain)
    if c is None:
        zero = torch.zeros((), dtype=torch.int64, device=o.x.device)
        c = torch.stack([zero, zero, torch.as_tensor(_live(o, mask) * scene.num_tris,
                                                      device=o.x.device)])
    return hit, c[:3]


class HitRecSoA(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    p: Vec3
    normal: Vec3  # flipped against the ray (set_face_normal, hittable.h:20-26)
    front_face: torch.Tensor
    tri: torch.Tensor
    mat: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def complete_hit(scene: SceneTensors, o: Vec3, d: Vec3, h: HitSoA) -> HitRecSoA:
    t_safe = torch.where(h.hit, h.t, 0.0)
    p = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    nrm = v3.gather(scene.normal, h.tri)
    front = v3.dot(d, nrm) < 0.0
    normal = v3.where(front, nrm, -nrm)
    u, v = h.u, h.v
    if scene.has_textures:
        # per-vertex UV interpolation (bpt_tpu/ops/soa.py:924-930); both
        # coordinates read the hit's own barycentrics
        uvt = scene.tri_uv[h.tri]
        u = uvt[:, 0] + h.u * (uvt[:, 2] - uvt[:, 0]) + h.v * (uvt[:, 4] - uvt[:, 0])
        v = uvt[:, 1] + h.u * (uvt[:, 3] - uvt[:, 1]) + h.v * (uvt[:, 5] - uvt[:, 1])
    return HitRecSoA(
        hit=h.hit, t=h.t, p=p, normal=normal, front_face=front,
        tri=h.tri, mat=scene.mat_id[h.tri], u=u, v=v,
    )


# ------------------------------------------------------------------ volumes


def _vol_closest(scene: SceneTensors, vid: int, o: Vec3, d: Vec3, tmin, tmax):
    """Closest boundary hit of volume ``vid`` with t in [tmin, tmax], which
    may be (-inf, inf): constant_medium probes with interval::universe
    (constant_medium.h:31-34).  A [VT, B] broadcast, min over VT."""
    det, t, u, v = _mt_all(scene.vol_v0, scene.vol_e1, scene.vol_e2, o, d)
    owner = (scene.vol_tri_vol == vid)[:, None]
    valid = owner & _mt_valid(det, t, u, v, tmin, tmax)
    return torch.where(valid, t, torch.inf).amin(dim=0)


def volume_interaction(scene: SceneTensors, o: Vec3, d: Vec3, tmin, t_surf,
                       u_rows, active):
    """constant_medium::hit (constant_medium.h:24-56) for every volume, in
    order, as if appended last to the hittable list: ``t_surf`` [B] (the
    closest surface t, inf on a miss) shrinks across them.  ``u_rows``: V
    rows of [B], one exponential free-flight draw a volume.

    Returns (hit [B] bool, t [B], phase material [B] int64)."""
    B = o.x.shape[0]
    dev = o.x.device
    d_len = v3.length(d)
    t_best = t_surf
    hit = torch.zeros((B,), dtype=torch.bool, device=dev)
    mat = torch.zeros((B,), dtype=torch.int64, device=dev)
    for vid in range(scene.num_volumes):
        t1 = _vol_closest(scene, vid, o, d, -torch.inf, torch.inf)
        t2 = _vol_closest(scene, vid, o, d, t1 + 1e-4, torch.inf)
        tt1 = torch.clamp_min(t1, tmin)
        tt2 = torch.minimum(t2, t_best)
        ok = active & torch.isfinite(t1) & torch.isfinite(t2) & (tt1 < tt2)
        tt1 = torch.clamp_min(tt1, 0.0)
        dist_inside = (tt2 - tt1) * d_len
        hd = scene.vol_neg_inv_density[vid] * torch.log(u_rows[vid])
        ok = ok & (hd <= dist_inside)
        tv = tt1 + hd / d_len
        t_best = torch.where(ok, tv, t_best)
        hit = hit | ok
        mat = torch.where(ok, scene.vol_mat[vid].to(torch.int64), mat)
    return hit, t_best, mat


def volume_record(rec: HitRecSoA, o: Vec3, d: Vec3, vhit, t_v, vmat) -> HitRecSoA:
    """The hit record with the volume interactions ``vhit`` at ``t_v``
    (phase material ``vmat``) in place of the surface hit: the reference's
    arbitrary normal (1, 0, 0), front_face true (constant_medium.h:48-49)
    and u = v = 0."""
    hit = rec.hit | vhit
    t = torch.where(vhit, t_v, rec.t)
    t_safe = torch.where(hit, t, 0.0)
    p = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return HitRecSoA(
        hit=hit, t=t, p=p,
        normal=v3.where(vhit, Vec3(one, zero, zero), rec.normal),
        front_face=rec.front_face | vhit,
        tri=rec.tri,
        mat=torch.where(vhit, vmat, rec.mat),
        u=torch.where(vhit, 0.0, rec.u),
        v=torch.where(vhit, 0.0, rec.v),
    )


def apply_volumes(scene: SceneTensors, o: Vec3, d: Vec3, rec: HitRecSoA, u_rows,
                  active):
    """The surface hit record overridden where a volume interaction comes
    first (``volume_interaction`` from T_MIN, then ``volume_record``).

    Returns (record, vmat): vmat [B] int64 is the phase material of the
    lanes that scattered in a volume and -1 elsewhere; a scene without
    volumes gives its record back and None."""
    if not scene.num_volumes:
        return rec, None
    t_surf = torch.where(rec.hit, rec.t, torch.inf)
    vhit, t_v, vmat = volume_interaction(scene, o, d, T_MIN, t_surf, u_rows, active)
    return volume_record(rec, o, d, vhit, t_v, vmat), torch.where(vhit, vmat, -1)
