"""Large-scene tracing: the BVH closest-hit and any-hit kernels and the
per-bounce PT wave.

Counterpart of ``bpt_tpu/ops/pallas/pt_wave.py`` (``pt_wave``,
``_coherence_key``, ``_launch_bounce``) and of the clustered hits that
``bpt_tpu``'s large-scene routes run,
``bpt_tpu/ops/pallas/cluster_wave.py::clustered_closest_ftb_pallas`` and
``clustered_any_ftb_pallas``: ``closest_bvh`` and ``any_bvh`` serve the BDPT
wavefront's traversals (``ops.soa.closest_hit`` / ``any_hit`` on a CUDA
scene) and ``pt_wave``'s paged mode.
``pt_wave`` takes the same arguments and returns the same outputs as
bpt_tpu's, except that the key is a ``(k1, k2)`` pair of ints, the
counters are exact int64, and they follow ``ops.soa.bvh_closest``'s
conventions (node visits, AABB hits, triangle tests and accepted tests of
the per-ray walk), not the cluster traversal's tile-level ones.

Ray state lives in one [STATE_ROWS, B] f32 tensor (origin, direction,
throughput, radiance, alive).  Between bounces a stable ``torch.sort`` of
``_coherence_key`` reorders the live rays and the state is gathered after
it, as bpt_tpu sorts in XLA between launches; the permutation is undone
at the end, and since every draw is keyed by (ray id, bounce) the sort
changes no result bit.  Two launches per bounce: ``closest_bvh`` walks
the live rays' BVH hits (on a persistent grid that refills finished lanes)
and ``pt_wave_bounce`` shades them; the wrapper ``pt_wave_bounce`` calls
``closest_bvh`` itself, or in paged mode (``paged=True``, the counterpart
of ``bpt_tpu``'s ``precomp``) is given its hits.  A scene without a BVH
(at most 256 triangles) takes its hits from ``closest_tri``
(``ops/kernels/intersect.py``), which ``_pt_wave`` calls before each
shade, as ``bpt_tpu``'s kernel sweeps such a scene's triangles itself.

Textured mode (``scene.has_textures``; bpt_tpu/ops/pallas/pt_wave.py:
546-608): the shade reads the material table with every textured
material's albedo set to 1.0 (``shade_scene``) and writes the hit point
into the origin of every live hit, those that end on an emitter included;
after each bounce ``texel_stage`` looks up the texel at the hit's
interpolated (u, v) and that point, multiplies it into the throughput of
the lanes that scattered off a textured non-dielectric surface and into
the radiance of the lanes that ended on a textured light.  The stage is
torch, as ``bpt_tpu`` runs it in XLA between its launches, and serves the
kernels and their plain versions alike; ``_pt_wave`` then computes each
bounce's hits itself, to keep their (u, v).

Float64: ``closest_bvh`` and ``any_bvh`` take a float64 scene, launching
the float64 instantiations of the walk kernels over each lane's own [tmin,
tmax] and the ``walk_tables64`` layout; they serve every float64 hit of a
scene with a BVH on the card (``ops.soa.wave_impl``'s "bvh64"), where
``bpt_tpu`` runs its jnp ``soa.bvh_closest`` / ``bvh_any``.  The shade
(``pt_wave_bounce``, ``pt_wave``) takes float32 only, as ``bpt_tpu``'s wave
does: ``render()`` renders float64 through the stratum loop.

Dispatch is by device: a CPU tensor takes the plain PyTorch version
(``ops.soa.bvh_closest``, ``ops.soa.bvh_any`` and ``models.pt.pt_bounce``);
a CUDA tensor launches ``csrc/pt_wave.cu`` or raises.  The wrappers count their launches
in ``<wrapper>.launches``, the plain versions their calls in
``<plain>.calls``.  Left out: bpt_tpu's TPU study options ``entry_sort``,
``pair_il`` and ``tile_rows``.

Volumes (bpt_tpu/ops/pallas/pt_wave.py:400-420, 566-583): on a scene with
constant-density volumes the shade runs the free-flight override after
each given hit (``csrc/volume.cuh``), a bounce draws NU + V slots, and a
lane that scatters in a volume gets -2 - its phase material in the hits'
tri, which the kernel writes in place; ``texel_stage`` reads the texel of
a textured phase material at (0, 0, p) for such a lane.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.pt import NU, kernel_stream_uniforms_fn, pt_bounce
from bpt_tpu_torch.ops import soa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels.pt_kernel import (
    _checked,
    _device_of,
    key_words,
    pack_shade_tables,
    shade_reject_reason,
    vol_args,
)
from bpt_tpu_torch.scene.textures import texture_value
from bpt_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_LIGHT,
    SceneTensors,
    per_scene,
)

STATE_ROWS = 13
OX, DX, THR, RAD, ALIVE = 0, 3, 6, 9, 12  # first row of each field


class BvhTables(NamedTuple):
    """The kernels' scene tables, on the scene's device."""

    nodes: torch.Tensor  # [N, 8] f32: min(3), max(3), skip, first*4 + count (int bits)
    tris: torch.Tensor  # [T, 12] f32: v0(3), e1(3), e2(3), normal(3)
    mat_id: torch.Tensor  # [T] int32
    mat: torch.Tensor  # [MAX_MATS*6] f32
    lgt: torch.Tensor  # [MAX_LIGHTS*13 + 3] f32, background at the tail


@per_scene
def walk_tables(scene: SceneTensors) -> tuple[torch.Tensor, torch.Tensor]:
    """(nodes, tris): the BVH in the walk's layout (csrc/pt_wave.cu: Bvh),
    32-byte nodes and 48-byte triangles, each a few float4 loads.  Packed
    once a scene and kept while the scene lives, since every traversal of a
    BDPT wave reads them."""
    ints = torch.stack([scene.bvh_skip, scene.bvh_first * 4 + scene.bvh_count],
                       dim=1).to(torch.int32)
    nodes = torch.cat([scene.bvh_min.to(torch.float32), scene.bvh_max.to(torch.float32),
                       ints.view(torch.float32)], dim=1).contiguous()
    tris = torch.cat([scene.v0, scene.e1, scene.e2, scene.normal],
                     dim=1).to(torch.float32).contiguous()
    return nodes, tris


@per_scene
def walk_tables64(scene: SceneTensors) -> tuple[torch.Tensor, torch.Tensor]:
    """(nodes, tris): the BVH in the float64 walk's layout (csrc/bvh_walk.cuh:
    Bvh64).  nodes [N, 8] f64, a node one 64-byte record that four 16-byte
    loads read: min x, max x, min y, max y, min z, max z, then skip and
    first*4 + count as two int32 in the seventh double, the eighth 0; tris
    [T, 10] f64, a triangle one 80-byte row of five 16-byte loads: v0, e1,
    e2, 0.  Packed once a scene, as ``walk_tables``."""
    f64 = torch.float64
    nodes = torch.zeros((scene.bvh_min.shape[0], 8), dtype=f64, device=scene.device)
    nodes[:, :6] = torch.stack([scene.bvh_min, scene.bvh_max], dim=2).reshape(-1, 6)
    links = nodes.view(torch.int32)[:, 12:14]
    links[:, 0] = scene.bvh_skip
    links[:, 1] = scene.bvh_first * 4 + scene.bvh_count
    tris = torch.cat([scene.v0, scene.e1, scene.e2, torch.zeros_like(scene.v0[:, :1])],
                     dim=1).to(f64).contiguous()
    return nodes, tris


@per_scene
def bounds_ok(scene: SceneTensors) -> bool:
    """No node bound of the scene's BVH is NaN: then the refilling walks' slab test
    of a ray with a finite origin and 1/d can leave out slab_axis's NaN
    checks (csrc/wave_walk.cuh), in float32.  Read once a scene."""
    return not bool(scene.bvh_min.isnan().any() or scene.bvh_max.isnan().any())


@per_scene
def bounds_ordered(scene: SceneTensors) -> bool:
    """Every node bound of the scene's BVH is finite and every node's min
    <= max (so none is NaN): then the float64 walks' slab test of a ray
    whose origin and 1/d are finite and 1/d not 0 picks each slab's pair
    by the sign of 1/d (csrc/wave_walk.cuh::slab_ord).  Read once a scene."""
    return bool(scene.bvh_min.isfinite().all() and scene.bvh_max.isfinite().all()
                and (scene.bvh_min <= scene.bvh_max).all())


def shade_scene(scene: SceneTensors) -> SceneTensors:
    """The scene as the wave's shade reads it: every textured material's
    albedo 1.0 and no UV interpolation (bpt_tpu/ops/pallas/pt_kernel.py:
    1066-1074), since ``texel_stage`` multiplies the texel in after the
    bounce.  An untextured scene is itself."""
    return _untextured(scene) if scene.has_textures else scene


@per_scene
def _untextured(scene: SceneTensors) -> SceneTensors:
    """``shade_scene`` of a textured scene, made once a scene (it holds
    the scene's tensors, not the scene)."""
    mats = scene.materials
    albedo = torch.where((mats.tex_id >= 0)[:, None], 1.0, mats.albedo)
    return dataclasses.replace(scene, materials=dataclasses.replace(mats, albedo=albedo),
                               has_textures=False)


def pack_bvh(scene: SceneTensors) -> BvhTables:
    """The scene in the wave kernel's layout: the walk's tables and the
    shading tables of ``shade_scene``.  The shade reads only the
    triangles' rows (normals) and material ids, packed from the triangle
    arrays; a scene of at most 256 triangles, which the walks never take,
    carries its BVH's arrays all the same (``scene/builder.py``)."""
    return BvhTables(*walk_tables(scene), scene.mat_id.to(torch.int32).contiguous(),
                     *pack_shade_tables(shade_scene(scene)))


@functools.lru_cache(maxsize=16)
def _slot_keys(key, dev, n_vols: int = 0) -> torch.Tensor:
    return key_words(rng.subkeys(key, NU + n_vols), dev)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


WALK_DTYPES = (torch.float32, torch.float64)


def walk_reject_reason(scene: SceneTensors) -> str:
    """Why the BVH walk kernels ``closest_bvh`` / ``any_bvh`` cannot take
    ``scene`` ('' if they can): they read only the walk's tables, in
    float32 (``walk_tables``) or float64 (``walk_tables64``).  The kernels
    that shade or walk clusters take float32 only (``shade_reject_reason``,
    ``cluster_wave.cluster_reject_reason``)."""
    if scene.dtype not in WALK_DTYPES:
        return (f"dtype {scene.dtype} (the BVH walk kernels take float32 or float64)")
    return ""


def _production(tmin, tmax) -> bool:
    """The interval the float32 walks take: tmin = T_MIN and, where given,
    tmax = inf, as Python numbers (``soa.wave_impl``'s "bvh")."""
    return soa._is_static(tmin, T_MIN) and (tmax is None or soa._is_static(tmax, torch.inf))


def _bound(x, B: int, dev, what: str):
    """tmin or tmax of a float64 launch: a contiguous [B] f64 tensor on the
    lanes' device (a Python number broadcast)."""
    if isinstance(x, torch.Tensor):
        return _checked(x, (B,), dev, what, torch.float64)
    return torch.full((B,), float(x), dtype=torch.float64, device=dev)


def _walk_args(what: str, scene: SceneTensors, o: Vec3, d: Vec3, lanes, tmin, tmax):
    """Checks a walk launch: (device, B, the six ray components in the
    scene's dtype, and in float64 tmin and, where given (the closest hit),
    tmax as [B] tensors; in float32 the production interval, which the
    kernels hold fixed, and None)."""
    dev = _device_of(lanes)
    reason = walk_reject_reason(scene)
    if reason:
        raise ValueError(f"{what} cannot take this scene: {reason}")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device} but lanes on {dev}")
    B = int(lanes.shape[0]) if lanes.dim() == 1 else -1
    ins = [_checked(x, (B,), dev, "ray component", scene.dtype) for x in (*o, *d)]
    if scene.dtype == torch.float32:
        if not _production(tmin, tmax):
            raise ValueError(f"{what} takes the interval (T_MIN, inf) / [T_MIN, tmax] in "
                             "float32; float64 takes any")
        return dev, B, ins, None
    return dev, B, ins, [_bound(x, B, dev, n) for x, n in ((tmin, "tmin"), (tmax, "tmax"))
                         if x is not None]


# ---------------------------------------------------------- closest hit


def closest_bvh_plain(scene, o: Vec3, d: Vec3, active, tmin=T_MIN, tmax=torch.inf):
    """Plain version of ``closest_bvh``."""
    closest_bvh_plain.calls += 1
    h = soa.bvh_closest(scene, o, d, tmin, tmax, active)
    tri = torch.where(h.hit, h.tri, -1).to(torch.int32)
    return h.t, tri, h.u, h.v, torch.stack(
        [h.node_visits, h.aabb_hits, h.tri_tests, h.tri_hits])


closest_bvh_plain.calls = 0


def closest_bvh(scene: SceneTensors, o: Vec3, d: Vec3, active, tmin=T_MIN, tmax=torch.inf):
    """Closest hit of the lanes ``active`` ([B] bool) by the threaded-DFS
    BVH walk, over (T_MIN, inf) in float32 and over each lane's own [tmin,
    tmax] (numbers or [B] f64 tensors) in float64, where an inactive lane
    counts as ``soa.bvh_closest(mask=...)`` counts it.  Returns (t [B], inf
    on a miss; tri [B] int32, -1 on a miss; u, v [B], in the scene's dtype;
    counters int64[4] = (node visits, AABB hits, triangle tests, triangle
    hits)).  The float64 launches count in ``.f64_launches`` too."""
    dev = _device_of(active)
    if dev.type == "cpu":
        return closest_bvh_plain(scene, o, d, active, tmin, tmax)
    dev, B, ins, bounds = _walk_args("closest_bvh", scene, o, d, active, tmin, tmax)
    act = _checked(active, (B,), dev, "active", torch.bool)
    kw = dict(dtype=scene.dtype, device=dev)
    t, u, v = (torch.empty(B, **kw) for _ in range(3))
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    counters = torch.zeros(5, dtype=torch.int64, device=dev)  # + the launch's work counter
    outs = (act, t, tri, u, v, counters)
    lib = build.load_library()
    with torch.cuda.device(dev):
        if bounds is None:
            nodes, tris = walk_tables(scene)
            code = lib.bpt_closest_bvh(
                B, int(nodes.shape[0]), int(bounds_ok(scene)), nodes.data_ptr(),
                tris.data_ptr(), *(x.data_ptr() for x in (*ins, *outs)), _stream(dev))
        else:
            nodes, tris = walk_tables64(scene)
            code = lib.bpt_closest_bvh_f64(
                B, int(nodes.shape[0]), int(bounds_ordered(scene)), nodes.data_ptr(),
                tris.data_ptr(), *(x.data_ptr() for x in (*ins, *bounds, *outs)),
                _stream(dev))
    build.check(code, "closest_bvh" if bounds is None else "closest_bvh (float64)")
    closest_bvh.launches += 1
    closest_bvh.f64_launches += bounds is not None
    return t, tri, u, v, counters[:4]


closest_bvh.launches = closest_bvh.f64_launches = 0


# -------------------------------------------------------------- any hit


def any_bvh_plain(scene, o: Vec3, d: Vec3, tmax, tmin=T_MIN):
    """Plain version of ``any_bvh``."""
    any_bvh_plain.calls += 1
    return soa.bvh_any(scene, o, d, tmin, tmax)


any_bvh_plain.calls = 0


def any_bvh(scene: SceneTensors, o: Vec3, d: Vec3, tmax, tmin=T_MIN):
    """Any hit over [T_MIN, tmax] in float32 and over [tmin, tmax] (tmin a
    number or a [B] f64 tensor) in float64, by the threaded-DFS BVH walk,
    which ends at the first leaf holding a hit; tmax [B] in the scene's
    dtype, a lane with tmax <= 0 is dead and misses without a walk.
    Returns (hit [B] bool, counters int64[4] = (node visits, AABB hits,
    triangle tests, triangle hits)), equal to ``ops.soa.bvh_any``'s on
    every lane.  The float64 launches count in ``.f64_launches`` too."""
    dev = _device_of(tmax)
    if dev.type == "cpu":
        return any_bvh_plain(scene, o, d, tmax, tmin)
    dev, B, ins, bounds = _walk_args("any_bvh", scene, o, d, tmax, tmin, None)
    tm = _checked(tmax, (B,), dev, "tmax", scene.dtype)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    counters = torch.zeros(5, dtype=torch.int64, device=dev)  # + the launch's work counter
    lib = build.load_library()
    with torch.cuda.device(dev):
        if bounds is None:
            nodes, tris = walk_tables(scene)
            code = lib.bpt_any_bvh(
                B, int(nodes.shape[0]), int(bounds_ok(scene)), nodes.data_ptr(),
                tris.data_ptr(), *(x.data_ptr() for x in ins), tm.data_ptr(),
                hit.data_ptr(), counters.data_ptr(), _stream(dev))
        else:
            nodes, tris = walk_tables64(scene)
            code = lib.bpt_any_bvh_f64(
                B, int(nodes.shape[0]), int(bounds_ordered(scene)), nodes.data_ptr(),
                tris.data_ptr(), *(x.data_ptr() for x in ins),
                bounds[0].data_ptr(), tm.data_ptr(), hit.data_ptr(), counters.data_ptr(),
                _stream(dev))
    build.check(code, "any_bvh" if bounds is None else "any_bvh (float64)")
    any_bvh.launches += 1
    any_bvh.f64_launches += bounds is not None
    return hit, counters[:4]


any_bvh.launches = any_bvh.f64_launches = 0


# --------------------------------------------------------------- bounce


def pt_wave_bounce_plain(scene, state, rid, key, bounce: int, hits=None):
    """Plain version of ``pt_wave_bounce``: ``models.pt.pt_bounce`` of
    ``shade_scene`` on the kernel stream, over ``ops.soa.bvh_closest``'s
    hits or the given ones (whose tri it marks, as the kernel does, where
    a lane scatters in a volume)."""
    pt_wave_bounce_plain.calls += 1
    scene = shade_scene(scene)
    o, d, thr = (Vec3(*state[k:k + 3]) for k in (OX, DX, THR))
    alive = state[ALIVE] > 0.5
    if hits is None:
        h = soa.bvh_closest(scene, o, d, T_MIN, torch.inf, alive)
        walk = [h.node_visits, h.aabb_hits, h.tri_tests, h.tri_hits]
    else:
        t, tri = hits
        zero = torch.zeros_like(t)
        h = soa.HitSoA(tri >= 0, t, torch.clamp_min(tri.long(), 0), zero, zero,
                       *([None] * 4))
        walk = [torch.zeros((), dtype=torch.int64, device=state.device)] * 4
    nv = scene.num_volumes
    u = kernel_stream_uniforms_fn(key, rid, state.dtype, nv)(bounce, NU + nv)
    rec, vmat = soa.apply_volumes(scene, o, d, soa.complete_hit(scene, o, d, h), u[NU:], alive)
    if vmat is not None and hits is not None:
        hits[1].copy_(torch.where(vmat >= 0, -2 - vmat, hits[1]))
    o, d, thr, inc, alive_new = pt_bounce(scene, o, d, thr, alive, h, u, rec=rec)
    rad = state[RAD:RAD + 3] + torch.stack(list(inc))
    out = torch.cat([torch.stack([*o, *d, *thr]), rad,
                     alive_new.to(state.dtype)[None]])
    return out, torch.stack([alive.sum(dtype=torch.int64), *walk])


pt_wave_bounce_plain.calls = 0


def pt_wave_bounce(scene: SceneTensors, state, rid, key, bounce: int,
                   hits=None, tables: BvhTables | None = None):
    """One PT bounce of every live lane: state [STATE_ROWS, B] f32 in
    (origin, direction, throughput, radiance, alive rows), rid [B] int32
    ray ids keying the draws with ``bounce``; ``hits`` = (t, tri) from
    ``closest_bvh`` or ``closest_tri``, else this calls ``closest_bvh`` on
    the live lanes first.  The shade is one launch (``.launches``); it
    reads ``shade_scene``'s materials and writes the hit point into the
    origin of every live hit.  On a volume scene it writes -2 - phase
    material into the given tri [B] int32 (contiguous, changed in place)
    where a lane scatters in a volume.

    Returns (the next state [STATE_ROWS, B] with this bounce's radiance
    added, counters int64[5] = (rays, node visits, AABB hits, triangle
    tests, triangle hits))."""
    dev = _device_of(state)
    if dev.type == "cpu":
        return pt_wave_bounce_plain(scene, state, rid, key, bounce, hits)
    reason = shade_reject_reason(scene)
    if reason:
        raise ValueError(f"pt_wave_bounce cannot take this scene: {reason}")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device} but lanes on {dev}")
    B = int(state.shape[1]) if state.dim() == 2 else -1
    st = _checked(state, (STATE_ROWS, B), dev, "state")
    rid = _checked(rid, (B,), dev, "rid", torch.int32)
    counters = torch.zeros(5, dtype=torch.int64, device=dev)
    if hits is None:
        t, tri, _, _, counters[1:] = closest_bvh(
            scene, Vec3(*st[OX:OX + 3]), Vec3(*st[DX:DX + 3]), st[ALIVE] > 0.5)
        hits = (t, tri)
    hits = (_checked(hits[0], (B,), dev, "hit t"), hits[1])
    if _checked(hits[1], (B,), dev, "hit tri", torch.int32) is not hits[1]:
        raise ValueError("pt_wave_bounce: hit tri must be contiguous (the shade writes it)")
    tables = tables if tables is not None else pack_bvh(scene)
    nv, VT, vol, volm = vol_args(scene)
    keys = _slot_keys(tuple(key), dev, nv)
    out = torch.empty_like(st)
    with torch.cuda.device(dev):
        code = build.load_library().bpt_pt_wave_bounce(
            B, int(tables.nodes.shape[0]), scene.num_lights, int(bounce),
            tables.nodes.data_ptr(), tables.tris.data_ptr(),
            tables.mat_id.data_ptr(), tables.mat.data_ptr(), tables.lgt.data_ptr(),
            keys.data_ptr(), st.data_ptr(), rid.data_ptr(), hits[0].data_ptr(),
            hits[1].data_ptr(), out.data_ptr(), counters.data_ptr(), nv, VT, vol, volm,
            _stream(dev))
    build.check(code, "pt_wave_bounce")
    pt_wave_bounce.launches += 1
    if nv:
        pt_wave_bounce.vol_launches += 1
    return out, counters


pt_wave_bounce.launches = pt_wave_bounce.vol_launches = 0


# ----------------------------------------------------------------- wave


def _coherence_key(lo, hi, ox, oy, oz, dx, dy, dz, alive_f):
    """bpt_tpu's fine coherence sort key (pt_wave.py:54-89): direction
    octant (major), a 12-bit origin cell, the dominant-axis bits as a
    tie-break; dead rays sort last."""
    i32 = torch.int32
    octant = ((dx > 0).to(i32) | ((dy > 0).to(i32) << 1)
              | ((dz > 0).to(i32) << 2))
    ext = torch.clamp_min(hi - lo, 1e-12)

    def q4(p, a):
        return (torch.clamp((p - lo[a]) / ext[a], 0.0, 1.0) * 15.0).to(i32)

    cell = (q4(ox, 0) << 8) | (q4(oy, 1) << 4) | q4(oz, 2)
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    dom = torch.where(ax >= torch.maximum(ay, az), 0,
                      torch.where(ay >= az, 1, 2)).to(i32)
    strong = (torch.maximum(ax, torch.maximum(ay, az))
              > 0.7 * torch.sqrt(ax * ax + ay * ay + az * az))
    fine = (octant << 15) | (cell << 3) | (dom << 1) | strong.to(i32)
    return torch.where(alive_f > 0.5, fine, 1 << 29)


def _sort_key(state):
    """_coherence_key over the live rays' origin bounds (the adaptive
    bounds of bpt_tpu's wave loop, pt_wave.py:463-475)."""
    live = state[ALIVE] > 0.5
    org = state[OX:OX + 3]
    big = 3.4e38
    lo = torch.where(live, org, big).amin(dim=1)
    hi = torch.where(live, org, -big).amax(dim=1)
    return _coherence_key(lo, hi, *state[OX:DX + 3], state[ALIVE])


def closest_sweep(scene: SceneTensors, o: Vec3, d: Vec3, active, plain: bool = False):
    """The closest hits of a scene without a BVH, with ``closest_bvh``'s
    outputs: ``closest_tri`` (or, ``plain``, its plain version) over (T_MIN,
    inf) for the lanes ``active`` and an empty interval for the rest;
    counters (0, 0, T tests a live lane, one accepted test a hit): the
    sweep of ``ops.soa.closest_hit``."""
    h = soa.closest_hit(scene, o, d, T_MIN, torch.inf, mask=active, plain=plain)
    return (h.t, torch.where(h.hit, h.tri, -1).to(torch.int32), h.u, h.v,
            torch.stack([h.node_visits, h.aabb_hits, h.tri_tests, h.tri_hits]))


def texel_stage(scene: SceneTensors, state, tri, u, v) -> None:
    """bpt_tpu's texel stage (pt_wave.py:546-608) on the state a bounce of
    ``shade_scene`` wrote, in place.  ``tri``, ``u``, ``v`` [B]: the
    bounce's closest hits (tri -1 on a miss or a lane that was dead, -2 -
    the phase material where the shade found a volume scatter); the
    state's radiance rows hold this bounce's radiance only.  At the hit's
    interpolated (u, v), in f32, or at (0, 0) in a volume, and the hit
    point the bounce wrote into the origin, the texel multiplies the
    throughput of the live lanes on a textured non-dielectric material
    (``tr * tex``, the kernel having shaded with albedo 1) and the radiance
    of the lanes that ended on a textured light (emission texel times the
    throughput they added)."""
    surf = tri >= 0
    vol = tri <= -2
    trc = torch.clamp(tri.long(), 0, scene.num_tris - 1)
    n_mats = int(scene.materials.mtype.shape[0])
    vmat = torch.clamp(-2 - tri.long(), 0, n_mats - 1)
    mat = torch.where(vol, vmat, scene.mat_id[trc])
    mtype = scene.materials.mtype[mat]
    tid = scene.materials.tex_id[mat]
    uvt = scene.tri_uv[trc].to(torch.float32)
    ui = uvt[:, 0] + u * (uvt[:, 2] - uvt[:, 0]) + v * (uvt[:, 4] - uvt[:, 0])
    vi = uvt[:, 1] + u * (uvt[:, 3] - uvt[:, 1]) + v * (uvt[:, 5] - uvt[:, 1])
    ui = torch.where(surf, ui, 0.0)
    vi = torch.where(surf, vi, 0.0)
    tex = texture_value(scene.textures, torch.clamp_min(tid, 0), ui, vi,
                        state[OX:OX + 3].T, with_noise=scene.has_noise).T  # [3, B]
    texd = (tid >= 0) & (surf | vol)
    take = (state[ALIVE] > 0.5) & texd & (mtype != MAT_DIELECTRIC)
    state[THR:THR + 3] = torch.where(take, state[THR:THR + 3] * tex, state[THR:THR + 3])
    light = texd & (mtype == MAT_LIGHT)
    state[RAD:RAD + 3] = torch.where(light, state[RAD:RAD + 3] * tex, state[RAD:RAD + 3])


def _pt_wave(scene, o: Vec3, d: Vec3, ray_ids, key, depth: int, sort: bool,
             paged: bool, plain: bool):
    reason = shade_reject_reason(scene)
    if reason:
        raise ValueError(f"pt_wave cannot render this scene: {reason}")
    dev = _device_of(ray_ids)
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device} but lanes on {dev}")
    B = int(ray_ids.shape[0])
    state = torch.empty((STATE_ROWS, B), dtype=torch.float32, device=dev)
    state[OX:DX + 3] = torch.stack([*o, *d]).to(torch.float32)
    state[THR:THR + 3] = 1.0
    state[RAD:RAD + 3] = 0.0
    state[ALIVE] = (ray_ids >= 0).to(torch.float32)
    rid = ray_ids.to(torch.int32)
    idx = torch.arange(B, device=dev)
    counters = torch.zeros(5, dtype=torch.int64, device=dev)
    if plain:
        closest, bounce = closest_bvh_plain, pt_wave_bounce_plain
    else:
        tables = pack_bvh(scene) if dev.type == "cuda" else None
        closest, bounce = closest_bvh, functools.partial(pt_wave_bounce, tables=tables)
    if not scene.use_bvh:
        closest = functools.partial(closest_sweep, plain=plain)
    textured = scene.has_textures
    given = paged or textured or not scene.use_bvh  # the hits come from this loop
    for b in range(depth):
        if sort and b > 0:  # primaries arrive raster-coherent
            perm = torch.sort(_sort_key(state), stable=True).indices
            state, rid, idx = state[:, perm], rid[perm], idx[perm]
        hits = None
        if given:
            t, tri, u, v, walk = closest(scene, Vec3(*state[OX:OX + 3]),
                                         Vec3(*state[DX:DX + 3]), state[ALIVE] > 0.5)
            counters[1:] += walk
            hits = (t, tri)
        if textured:  # the bounce adds its radiance to zeros; the stage scales it
            rad = state[RAD:RAD + 3].clone()
            state[RAD:RAD + 3] = 0.0
        state, c = bounce(scene, state, rid, key, b, hits)
        counters += c
        if textured:
            texel_stage(scene, state, tri, u, v)
            state[RAD:RAD + 3] += rad
    # depth-exhausted entries still count (camera.h:256)
    rays = counters[0] + (state[ALIVE] > 0.5).sum(dtype=torch.int64)
    rad = torch.empty((3, B), dtype=torch.float32, device=dev)
    rad[:, idx] = state[RAD:RAD + 3]  # undo the sort
    return rad[0], rad[1], rad[2], rays, counters[1:]


def pt_wave(scene: SceneTensors, o: Vec3, d: Vec3, ray_ids, key, depth: int,
            sort: bool = True, paged: bool = False):
    """Sorted per-bounce wavefront PT.  o, d: Vec3 of [B]; ray_ids [B] int
    (negative = inactive); key: the PT stream's key (the render's
    ``fold_in(key, 1)``).  The wrapper ``pt_wave_bounce`` computes the
    hits of a scene with a BVH unless ``paged`` or textured, where this
    loop calls ``closest_bvh`` first; a scene without one takes its hits
    from ``closest_tri``.  A textured scene runs ``texel_stage`` after
    each bounce.

    Returns (rad_x, rad_y, rad_z [B] f32, rays_traced int64,
    extra int64[4] = (node_visits, aabb_hits, tri_tests, tri_hits))."""
    return _pt_wave(scene, o, d, ray_ids, key, depth, sort, paged, plain=False)


def pt_wave_plain(scene: SceneTensors, o: Vec3, d: Vec3, ray_ids, key,
                  depth: int, sort: bool = True, paged: bool = False):
    """Plain version of ``pt_wave``: the same loop over the plain versions
    of both kernels, on any device."""
    pt_wave_plain.calls += 1
    return _pt_wave(scene, o, d, ray_ids, key, depth, sort, paged, plain=True)


pt_wave_plain.calls = 0
