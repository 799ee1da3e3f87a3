"""Unidirectional path tracer with next-event estimation — the wavefront
form of the reference's recursive path_trace_color (src/camera.h:255-292),
counterpart of ``bpt_tpu.models.pt``.

Per bounce, the whole ray batch moves through: intersect wave -> emission
-> delta-follow or 50/50 light/BSDF mixture sampling -> throughput update.
No Russian roulette, hard max_depth cutoff, emission dropped on delta
bounces (camera.h:273-275).  Randomness enters only through
``uniforms_fn(bounce, n) -> n rows of [B]``: NU rows a bounce, and on a
scene with V constant-density volumes V more, the free-flight draws of
the override that follows each closest hit (``soa.apply_volumes``).

This wavefront is the plain version the CUDA megakernel
(``ops/kernels/pt_kernel.py``) is held against, and the render's estimator
wherever ``path_trace_fast`` takes its jnp branch, its closest hits on the
CUDA hit kernels of a CUDA scene (``ops.soa.closest_hit``).

Dispatch of ``path_trace_fast`` / ``path_trace_pixels_fast``, as
``bpt_tpu``'s (models/pt.py:54-131): on a CUDA scene the estimators follow
``bpt_tpu``'s TPU dispatch, on a CPU scene its CPU dispatch, which is the
jnp estimators.  ``plain`` keeps the card's branches and swaps every kernel
for its plain version (only comparisons pass it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.camera import CameraConstants, generate_rays
from bpt_tpu_torch.ops import shade_soa as sh
from bpt_tpu_torch.ops import soa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.scene.types import MAT_LIGHT, SceneTensors

# uniform slot layout per bounce
U_MIX = 0  # mixture_pdf 50/50 choice (pdf.h:82-86)
U_LPICK = 1  # light triangle pick (triangle.h:187)
U_LU = 2  # light barycentric u
U_LV = 3  # light barycentric v
U_B1 = 4  # bsdf dir sample
U_B2 = 5
U_DIEL = 6  # dielectric reflect/refract choice (material.h:109)
U_FZ1 = 7  # metal fuzz sphere dir
U_FZ2 = 8
NU = rng.NU


class PTStats(NamedTuple):
    """Exact int64 counters (reference BvhStats, src/core/stats.h:8-16)."""

    rays_traced: torch.Tensor
    node_visits: torch.Tensor
    aabb_hits: torch.Tensor
    tri_tests: torch.Tensor
    tri_hits: torch.Tensor


def default_uniforms_fn(key, ray_ids, dtype):
    """The jnp stream as uniform rows (``bpt_tpu.models.pt.
    default_uniforms_fn`` without ``sel``): ``fn(bounce, n)`` gives
    ``rng.uniform_rows(key, ray_ids, bounce, n)``.  ``key``: (k1, k2)
    ints; ``ray_ids``: [B] int tensor."""

    def fn(bounce, n):
        return rng.uniform_rows(key, ray_ids, bounce, n, dtype)

    return fn


def kernel_stream_uniforms_fn(key, ray_ids, dtype, n_vols: int = 0):
    """The PT megakernel's in-kernel threefry stream as uniform rows:
    per-slot subkeys, the bounce in the threefry COUNTER, and paired draws
    — even slot s takes x0 of threefry(keys[s], (rid, bounce)), odd slot s
    takes x1 of the s-1 call; the odd tail slot (U_FZ2) and the volume
    free-flight slots NU..NU+n_vols-1 are single draws.
    ``key``: (k1, k2) ints; ``ray_ids``: [B] int tensor."""
    keys = rng.subkeys(key, NU + n_vols)
    ridw = rng.ray_words(ray_ids)

    def fn(bounce, n):
        ctr = torch.full_like(ridw, int(bounce) & rng.MASK32)
        rows = []
        s = 0
        while len(rows) < n:
            b0, b1 = rng.threefry2x32(keys[2 * s], keys[2 * s + 1], ridw, ctr)
            rows.append(rng.bits_to_unit_float(b0).to(dtype))
            if s + 1 < NU:  # a surface pair: word x1 is slot s + 1
                rows.append(rng.bits_to_unit_float(b1).to(dtype))
                s += 2
            else:  # the odd tail slot and the volume slots: single draws
                s += 1
        return rows[:n]

    return fn


def array_uniforms_fn(uniforms):
    """uniforms: [B, D, NU + V] — the injected-uniform path."""
    rows_all = torch.movedim(uniforms, 0, -1)  # [D, NU + V, B]

    def fn(bounce, n):
        step = rows_all[bounce]
        return [step[i] for i in range(n)]

    return fn


def pt_bounce(scene: SceneTensors, o: Vec3, d: Vec3, thr: Vec3, alive, h, u,
              rec=None):
    """One bounce of the estimator for the lanes ``alive`` (camera.h:
    255-292) given their closest hit ``h`` (a HitSoA) and the bounce's
    uniform rows ``u`` (NU, + V free-flight draws on a volume scene): miss
    -> background, one-sided emission, delta continuation or the 50/50
    light/BSDF mixture.  ``rec``: the bounce's hit record after the
    free-flight override (``soa.apply_volumes``), if the caller has it.

    Returns (o, d, thr, radiance added this bounce, alive_new); o is the
    hit point on every live hit, the ray's origin elsewhere."""
    bg = Vec3(scene.background[0], scene.background[1], scene.background[2])
    if rec is None:
        rec = soa.apply_volumes(scene, o, d, soa.complete_hit(scene, o, d, h), u[NU:],
                                alive)[0]
    mtype = scene.materials.mtype[rec.mat]

    zero = torch.zeros_like(thr.x)
    miss = alive & ~rec.hit
    rad = v3.scale_add(Vec3(zero, zero, zero), miss, thr * bg)

    live_hit = alive & rec.hit
    emission = sh.emitted(scene, rec.mat, rec.front_face, rec.u, rec.v, rec.p)
    delta = sh.is_delta(mtype)
    can_scatter = mtype != MAT_LIGHT

    # non-delta lanes add emission (skip_pdf lanes drop it, camera.h:273)
    rad = v3.scale_add(rad, live_hit & ~delta, thr * emission)

    atten = sh.attenuation(scene, rec.mat, mtype, rec.u, rec.v, rec.p)

    # delta continuation (camera.h:273-275)
    d_delta = sh.delta_scatter_dir(
        scene, rec.mat, mtype, d, rec.normal, rec.front_face,
        u[U_DIEL], u[U_FZ1], u[U_FZ2],
    )

    # mixture sampling (camera.h:277-289)
    light_dir = sh.sample_light_dir(scene, rec.p, u[U_LPICK], u[U_LU], u[U_LV])
    bsdf_dir = sh.sample_bsdf_dir(mtype, rec.normal, u[U_B1], u[U_B2])
    pick_light = u[U_MIX] < 0.5
    d_diff = v3.where(pick_light, light_dir, bsdf_dir)

    pdf_val = 0.5 * sh.light_pdf_value(scene, rec.p, d_diff) + \
        0.5 * sh.bsdf_pdf_value(mtype, rec.normal, d_diff)
    scat_pdf = sh.scattering_pdf(mtype, rec.normal, d_diff)

    diffuse_ok = live_hit & can_scatter & ~delta & (pdf_val > 0.0)
    delta_ok = live_hit & can_scatter & delta

    w = torch.where(pdf_val > 0.0,
                    scat_pdf / torch.where(pdf_val > 0.0, pdf_val, 1.0), 0.0)
    thr = v3.where(
        delta_ok,
        thr * atten,
        v3.where(diffuse_ok, thr * atten * w, thr),
    )

    alive_new = delta_ok | diffuse_ok
    # every live hit writes its point, those ending here included: the
    # wave's texel stage reads it (bpt_tpu/ops/pallas/pt_kernel.py:661-667)
    o = v3.where(live_hit, rec.p, o)
    d = v3.where(alive_new, v3.where(delta_ok, d_delta, d_diff), d)
    return o, d, thr, rad, alive_new


def path_trace_radiance(scene: SceneTensors, origins, dirs, max_depth: int,
                        uniforms_fn, plain: bool = False):
    """Radiance for a batch of primary rays. origins/dirs: [B,3].
    ``plain``: the closest hits walk the BVH in torch on any device.

    Returns (radiance [B,3], PTStats)."""
    B = origins.shape[0]
    dtype = origins.dtype
    dev = origins.device
    o = v3.from_array(origins)
    d = v3.from_array(dirs)

    thr = Vec3(*(torch.ones(B, dtype=dtype, device=dev) for _ in range(3)))
    rad = Vec3(*(torch.zeros(B, dtype=dtype, device=dev) for _ in range(3)))
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = PTStats(zero, zero, zero, zero, zero)

    for b in range(max_depth):
        h = soa.closest_hit(scene, o, d, T_MIN, torch.inf, mask=alive, plain=plain)
        o, d, thr, inc, alive_new = pt_bounce(scene, o, d, thr, alive, h,
                                              uniforms_fn(b, NU + scene.num_volumes))
        # a path adds radiance only on the bounce it ends, so this sum
        # rounds as one accumulator would
        rad = rad + inc
        stats = PTStats(
            rays_traced=stats.rays_traced + alive.sum(dtype=torch.int64),
            node_visits=stats.node_visits + h.node_visits,
            aabb_hits=stats.aabb_hits + h.aabb_hits,
            tri_tests=stats.tri_tests + h.tri_tests,
            tri_hits=stats.tri_hits + h.tri_hits,
        )
        alive = alive_new

    # depth-exhausted entry still bumps rays_traced (camera.h:256 runs before
    # the depth<=0 check)
    stats = stats._replace(
        rays_traced=stats.rays_traced + alive.sum(dtype=torch.int64))
    return v3.to_array(rad), stats


def _megakernel_ok(scene: SceneTensors) -> bool:
    from bpt_tpu_torch.ops.kernels.pt_kernel import megakernel_reject_reason

    return scene.device.type == "cuda" and not megakernel_reject_reason(scene, "pt")


def path_trace_fast(scene: SceneTensors, origins, dirs, ray_ids, key, max_depth: int,
                    plain: bool = False):
    """PT radiance of primary rays (bpt_tpu/models/pt.py:54-86).  ray_ids
    [B] int, negative = inactive (a zero radiance); ``key``: the PT
    stream's key (the render's ``fold_in(key, 1)``).  A CUDA scene that
    the megakernel takes launches ``pt_megakernel`` in rays mode (its own
    threefry stream); every other scene runs ``path_trace_radiance`` on the
    jnp stream, keyed by the absolute ray id.

    Returns (radiance [B,3], PTStats)."""
    if _megakernel_ok(scene):
        from bpt_tpu_torch.ops.kernels import pt_kernel as pk  # imports this module

        launch = pk.pt_megakernel_plain if plain else pk.pt_megakernel
        rx, ry, rz, rays, extra = launch(scene, Vec3(*origins.unbind(1)),
                                         Vec3(*dirs.unbind(1)), ray_ids, key, max_depth)
        return torch.stack([rx, ry, rz], dim=-1), PTStats(rays, *extra)
    active = ray_ids >= 0
    rad, stats = path_trace_radiance(
        scene, origins, dirs, max_depth,
        default_uniforms_fn(key, torch.clamp_min(ray_ids, 0), origins.dtype), plain=plain)
    return torch.where(active[:, None], rad, 0.0), stats


def path_trace_pixels_fast(scene: SceneTensors, i, j, sx, sy, ray_ids,
                           cc: CameraConstants, key, max_depth: int, plain: bool = False):
    """PT radiance of one sample of each pixel (bpt_tpu/models/pt.py:
    89-131): i, j pixel coordinates, sx, sy stratum indices, ray_ids [B]
    the absolute sample ids pix*spp + s (negative = inactive); ``key``: the
    render key.  A CUDA scene that the megakernel takes, without defocus,
    launches ``pt_megakernel_pixels`` (raygen in the kernel, its jitter
    stream); otherwise the jnp raygen (``fold_in(key, 0)``) feeds
    ``path_trace_fast`` on ``fold_in(key, 1)``.  The two routes draw
    different jitter, as in ``bpt_tpu``.

    Returns (radiance [B,3], PTStats)."""
    if _megakernel_ok(scene) and not cc.defocus:
        from bpt_tpu_torch.ops.kernels import pt_kernel as pk  # imports this module

        launch = pk.pt_megakernel_pixels_plain if plain else pk.pt_megakernel_pixels
        rx, ry, rz, rays, extra = launch(scene, i, j, sx, sy, ray_ids,
                                         pk.camera_table(cc), key, max_depth)
        return torch.stack([rx, ry, rz], dim=-1), PTStats(rays, *extra)
    u_gen = rng.wave_uniforms(rng.fold_in(key, 0), torch.clamp_min(ray_ids, 0), 0, 4,
                              i.dtype)
    o, d = generate_rays(cc, i, j, sx, sy, u_gen)
    return path_trace_fast(scene, o, d, ray_ids, rng.fold_in(key, 1), max_depth,
                           plain=plain)
