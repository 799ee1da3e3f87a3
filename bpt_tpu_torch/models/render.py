"""Render loop: the chunked fused-megakernel loop of
``bpt_tpu.models.render`` for PT and BDPT (render.py:157-224, 759-817),
the spp-batched ``pt_wave`` loop for PT on large scenes (render.py:243-368,
665-712), the BDPT wave loop for BDPT on them
(render.py:371-497, 713-755), and the jnp stratum loop (render.py:76-128,
819-867) for everything else: defocus, ref_vis, float64, scenes over the
megakernels' capacity and stratum checkpoints of the jnp stream.

Each chunk of pixels of the fused loop is one ``pt_megakernel_pixels``
call (integrator pt) or one ``bdpt_megakernel_pixels`` call (bdpt,
bdpt-mis) that runs every sample stratum of those pixels, brute force on
a scene of at most 512 triangles and walking the BVH of a larger one; the
framebuffer is a running sum, which gives free checkpoint/resume at chunk
granularity.  The other loops run batches of sample strata over the whole
image, with stratum checkpoints: ``pt_wave``, or ``models.pt.path_trace_
pixels_fast`` / ``models.bdpt.bdpt_fast``, whose dispatch follows
``bpt_tpu``'s TPU dispatch on a CUDA scene and its CPU dispatch on a CPU
scene; the BDPT wave loop is the same loop over ``bdpt_jnp`` on every
scene, as ``bpt_tpu``'s wave runs its jnp estimator.  Every
draw is keyed by the absolute sample id pix*spp + s, so the image depends
neither on the chunk size nor on the batch.  On a CUDA scene the loops run
the CUDA kernels; on a CPU scene they run the kernels' plain versions or
the jnp estimators.  ``render_part`` renders a pixel range of any route
(the shards of ``bpt_tpu_torch.parallel``), equal to the same rows of
``render()``; ``render_resilient`` resumes a failed render from its last
checkpoint unit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.models.bdpt import bdpt_fast, bdpt_jnp
from bpt_tpu_torch.models.camera import camera_constants, generate_rays
from bpt_tpu_torch.models.pt import path_trace_pixels_fast
from bpt_tpu_torch.ops.film import to_rgb8
from bpt_tpu_torch.ops.kernels.bdpt_kernel import MAX_DEPTH, bdpt_megakernel_pixels
from bpt_tpu_torch.ops.kernels.pt_kernel import (
    INTEGRATORS,
    MAX_TRIS,
    camera_table,
    megakernel_reject_reason,
    pt_megakernel_pixels,
    shade_reject_reason,
)
from bpt_tpu_torch.ops.kernels.pt_wave import pt_wave, walk_reject_reason
from bpt_tpu_torch.scene.types import CameraConfig, SceneTensors
from bpt_tpu_torch.utils.stats import RenderStats


@dataclass
class RenderResult:
    framebuffer_sum: np.ndarray  # [H,W,3] sum of per-sample radiance
    samples_per_pixel: int
    stats: RenderStats
    width: int
    height: int

    def rgb8(self, nan_scrub: bool = True) -> np.ndarray:
        return to_rgb8(torch.from_numpy(self.framebuffer_sum),
                       self.samples_per_pixel, nan_scrub).numpy()


def default_chunk_size(npix: int) -> int:
    """Pixels per fused launch (bpt_tpu default_chunk_size(fused=True)):
    launch granularity only, since all per-lane state lives in the kernel."""
    return int(min(1 << 18, max(1024, npix)))


def _resume_kind(resume) -> str:
    if not resume or int(resume.get("units_done",
                                    resume.get("strata_done", 0))) == 0:
        return ""  # fresh render: any loop shape may start it
    return resume.get("unit_kind", "stratum")


def _wave_spp_batch(npix: int, spp_eff: int) -> int:
    """Sample strata per pt_wave call (bpt_tpu's _wave_spp_batch): the
    whole image times as many strata as keep a wave at <= 2^22 rays."""
    return max(1, min(spp_eff, (1 << 22) // max(1, npix)))


# Peak device bytes of one bdpt_fast wave per ray, for a subpath depth S:
# BYTES_PER_RAY[dtype][mis] = (per S^2, per S, constant).  Float32: the
# least-squares fit of torch.cuda.max_memory_allocated over coffee waves of
# 65,536 rays at S = 2, 5, 10, 20, 40 and 80 on an H100
# (tools/probe_bdpt_wave_memory.py; PERF.md, the coffee BDPT cells) was
# 409.3 S + 141.4 without MIS and 10.68 S^2 + 380.4 S + 933.0 with it,
# within 4% of every point; these lie 8-32% above every point, and 7% above
# the 512x512 / 4 spp / depth 10 bdpt-mis render's one 2^20-ray wave (6.19
# GiB).  Float64, where every BDPT render takes the stratum loop: the same
# fit over the same waves in float64 (``--f64``) was 813.7 S + 260.5 and
# 20.32 S^2 + 817.5 S + 1,319.6, within 4.5%, 1.6-2.1x float32's; these lie
# 8-29% above every point, and 9% above the float64 render's 2^20-ray wave
# (11.53 GiB; PERF.md §6).  A wave holds as many rays as keep that
# peak under BDPT_WAVE_BYTES, under a third of the card's 80 GB, which
# leaves room for the allocator's slack and the caller's tensors; the
# 512x512 / 4 spp / depth 80 bdpt-mis render, split into pixel ranges,
# peaked at 18.2 GiB in float32.
BYTES_PER_RAY = {torch.float32: {False: (0, 470, 160), True: (15, 440, 900)},
                 torch.float64: {False: (0, 900, 400), True: (24, 880, 1700)}}
BDPT_WAVE_BYTES = 24 << 30


def _resume_stream(resume) -> str:
    """Which RNG stream wrote a stratum-kind checkpoint ("wave": pt_wave's
    megakernel-parity jitter; "jnp": the stratum loop); "" otherwise."""
    if _resume_kind(resume) != "stratum":
        return ""
    return resume.get("stream", "")


# bpt_tpu's routing constants, measured on a TPU and mirrored here, not
# re-measured on the H100: its BDPT wave loop beats the fused megakernel
# only from 2^18 samples a render (bpt_tpu/models/render.py:407-410), and
# its jnp BDPT estimator unrolls its loops only to depth UNROLL_MAX = 32
# (bpt_tpu/models/bdpt.py:66), past which deep BDPT takes the fused
# megakernel (render.py:396-402).  bpt_tpu also sends PT under 2^18
# pixels to the fused megakernel (render.py:291-296); the port sends it to
# pt_wave, which renders coffee PT at 256x256 / 16 spp 5.6x faster than
# the walk-mode megakernel on the H100 (PERF.md, Findings; ROADMAP §3).
WAVE_MIN_RAYS = 1 << 18
UNROLL_MAX = 32


def _route(scene: SceneTensors, cfg: CameraConfig, integrator: str, resume) -> str:
    """bpt_tpu's order (render.py:665-867):

    1. ``"wave"``: PT on a scene over 512 triangles, through pt_wave, at
       2^18 pixels or more or where the fused loop would take it (bpt_tpu
       takes the fused loop there), and on a textured scene of any size at
       2^18 pixels or more (render.py:300-303), unless ref_vis, over the
       shade tables' capacity or resuming a checkpoint of another loop;
    2. ``"bdpt_wave"``: BDPT on a float32 scene over 512 triangles at 2^18
       samples or more and depth <= 32, without ref_vis, starting fresh or
       resuming a jnp stratum checkpoint: the stratum loop on the jnp
       estimator;
    3. ``"fused"``: the megakernels' chunk loop, for a scene they take
       (brute force up to 512 triangles, a BVH walk above) without defocus
       or ref_vis, starting fresh or resuming a chunk-kind checkpoint;
    4. ``"strata"``: the jnp stratum loop, for everything else, textured
       scenes the other routes leave included."""
    kind, stream = _resume_kind(resume), _resume_stream(resume)
    large = scene.num_tris > MAX_TRIS
    npix = cfg.image_width * cfg.image_height
    fused_ok = (cfg.defocus_angle <= 0.0 and not cfg.ref_vis
                and not megakernel_reject_reason(scene, integrator))
    if (integrator == "pt" and (large or scene.has_textures)
            and (npix >= WAVE_MIN_RAYS or fused_ok)
            and not cfg.ref_vis and not shade_reject_reason(scene)
            and kind in ("", "stratum") and stream in ("", "wave")):
        return "wave"
    if (integrator != "pt" and large and npix * cfg.effective_spp >= WAVE_MIN_RAYS
            and cfg.max_depth <= UNROLL_MAX and scene.dtype == torch.float32
            and not cfg.ref_vis and kind in ("", "stratum") and stream in ("", "jnp")):
        return "bdpt_wave"
    if fused_ok and kind in ("", "chunk"):
        return "fused"
    return "strata"


def _reject_reason(scene: SceneTensors, cfg: CameraConfig, integrator: str,
                   route: str) -> str:
    if integrator not in INTEGRATORS:
        return f"unknown integrator {integrator!r} (not one of {', '.join(INTEGRATORS)})"
    if integrator != "pt" and not 1 <= cfg.max_depth <= MAX_DEPTH:
        return (f"BDPT max_depth {cfg.max_depth} outside 1..{MAX_DEPTH}, the "
                "CUDA kernel's vertex-scratch bound")
    if route in ("wave", "fused"):
        return ""  # the route was chosen because its kernels take the scene
    if scene.device.type == "cuda" and scene.use_bvh:
        return walk_reject_reason(scene)
    return ""


def _bdpt_wave_shape(npix: int, spp_eff: int, depth: int, mis: bool,
                     dtype=torch.float32) -> tuple[int, int]:
    """(strata per wave, pixels per wave): as many whole strata of the
    image as keep a wave's peak memory under BDPT_WAVE_BYTES (bpt_tpu's
    _bdpt_wave_batch, on the port's own measured bytes of the scene's
    dtype), else one stratum in ranges of as many pixels as do."""
    a, b, c = BYTES_PER_RAY[dtype][mis]
    S = max(1, depth)
    cap = max(1, BDPT_WAVE_BYTES // (a * S * S + b * S + c))
    if cap >= npix:
        return min(spp_eff, cap // npix), npix
    return 1, cap


def _render_chunks(scene, cfg, cc, integrator, seed, fb, chunk_size,
                   chunks_done, bar, stratum_callback, p0=0, p1=None):
    """The fused loop over pixels [p0, p1) (default the whole image):
    each chunk of pixels is one megakernel call that runs all its strata;
    ``fb`` holds the range's rows.  Returns (rays, shadow rays, extra
    int64[4])."""
    dev = scene.device
    W, H = cc.width, cc.height
    p1 = W * H if p1 is None else p1
    S = cfg.sqrt_spp
    n_chunks = int(np.ceil((p1 - p0) / chunk_size))
    key = rng.prng_key(seed)
    cam = camera_table(cc)
    rays_acc = torch.zeros((), dtype=torch.int64, device=dev)
    shadow_acc = torch.zeros((), dtype=torch.int64, device=dev)
    extra_acc = torch.zeros(4, dtype=torch.int64, device=dev)
    for c in range(chunks_done, n_chunks):
        pix = p0 + c * chunk_size + torch.arange(chunk_size, dtype=torch.int64, device=dev)
        in_range = pix < p1
        pixc = torch.clamp_max(pix, p1 - 1)
        i = (pixc % W).to(scene.dtype)
        j = (pixc // W).to(scene.dtype)
        ids = torch.where(in_range, pixc, -1)
        if integrator == "pt":
            rx, ry, rz, rays, extra = pt_megakernel_pixels(
                scene, i, j, i * 0, j * 0, ids, cam, key, cfg.max_depth,
                spp_loop=S * S, sqrt_spp=S,
            )
        else:
            rx, ry, rz, rays, shadow, extra = bdpt_megakernel_pixels(
                scene, i, j, ids, cam, key, cfg.max_depth, S,
                mis=integrator == "bdpt-mis",
            )
            shadow_acc += shadow
        # the in-range lanes are the chunk's first n pixels, in order: a
        # slice add (deterministic, no index, no host sync)
        n = min(chunk_size, p1 - p0 - c * chunk_size)
        fb[c * chunk_size:c * chunk_size + n] += torch.stack([rx, ry, rz], dim=-1)[:n]
        rays_acc += rays
        extra_acc += extra
        if bar:
            bar.update()
        if stratum_callback is not None:
            stratum_callback(dict(
                framebuffer_sum=fb.cpu().numpy().reshape(H, W, 3).copy(),
                strata_done=c + 1, units_done=c + 1,
                unit_kind="chunk", seed=seed, chunk_size=chunk_size,
            ))
    return rays_acc, shadow_acc, extra_acc


def _render_wave(scene, cfg, cc, seed, fb, strata_done, bar, stratum_callback,
                 p0=0, p1=None):
    """bpt_tpu's pt_wave loop (render.py:665-712 over _make_step_pt_wave):
    batches of strata over pixels [p0, p1) (default the whole image), each
    one pt_wave call, added to the framebuffer in stratum order; the
    primary rays' jitter (and the defocus disk's draws) on the megakernel's
    stream.  Returns (rays, extra int64[4])."""
    dev, dtype = scene.device, scene.dtype
    W, H = cc.width, cc.height
    p1 = W * H if p1 is None else p1
    npix = p1 - p0
    S = cfg.sqrt_spp
    spp_eff = S * S
    batch = _wave_spp_batch(npix, spp_eff)
    key = rng.prng_key(seed)
    key_pt = rng.fold_in(key, 1)
    pix = p0 + torch.arange(npix, dtype=torch.int64, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    extra = torch.zeros(4, dtype=torch.int64, device=dev)
    s_lin = strata_done
    while s_lin < spp_eff:
        b = min(batch, spp_eff - s_lin)
        i = (pix % W).to(dtype).repeat(b)
        j = (pix // W).to(dtype).repeat(b)
        s = s_lin + torch.arange(b, device=dev).repeat_interleave(npix)
        ray_ids = pix.repeat(b) * spp_eff + s
        if cc.defocus:  # the disk pair: a second threefry call
            u = rng.raygen_jitter(key, ray_ids, defocus=True)
        else:
            u0, u1 = rng.raygen_jitter(key, ray_ids)
            u = (u0, u1, torch.zeros_like(u0), torch.zeros_like(u0))
        o3, d3 = generate_rays(cc, i, j, (s % S).to(dtype), (s // S).to(dtype),
                               torch.stack(u, -1).to(dtype))
        rx, ry, rz, r, e = pt_wave(scene, v3.from_array(o3), v3.from_array(d3),
                                   ray_ids.to(torch.int32), key_pt, cfg.max_depth)
        rad = torch.stack([rx, ry, rz], dim=-1).to(dtype).reshape(b, npix, 3)
        for k in range(b):  # stratum-order left fold
            fb += rad[k]
        rays += r
        extra += e
        s_lin += b
        if bar:
            bar.update(b)
        if stratum_callback is not None:
            stratum_callback(dict(
                framebuffer_sum=fb.cpu().numpy().reshape(H, W, 3).copy(),
                strata_done=s_lin, units_done=s_lin, unit_kind="stratum",
                seed=seed, stream="wave",
            ))
    return rays, extra


def jnp_raygen(cc, pix, s, key, dtype):
    """The primary rays of bpt_tpu's jnp loops (render.py:461-470, 101-104)
    for pixel ids ``pix`` and strata ``s`` ([N] int64 each) under the render
    key ``key``: the jitter and defocus-disk draws are
    ``wave_uniforms(fold_in(key, 0), ray ids, 0, 4)``.  Returns (origins,
    directions [N, 3], ray ids pix*spp + s)."""
    S, W = cc.sqrt_spp, cc.width
    ray_ids = pix * (S * S) + s
    u_gen = rng.wave_uniforms(rng.fold_in(key, 0), ray_ids, 0, 4, dtype)
    o, d = generate_rays(cc, (pix % W).to(dtype), (pix // W).to(dtype),
                         (s % S).to(dtype), (s // S).to(dtype), u_gen)
    return o, d, ray_ids


def _render_strata(scene, cfg, cc, integrator, seed, fb, strata, bar,
                   stratum_callback, plain: bool = False, bdpt_wave: bool = False,
                   p0=0, p1=None):
    """bpt_tpu's jnp stratum loop (render.py:819-867 over _make_step) and
    its large-scene BDPT wave loop (render.py:713-755 over
    _make_step_bdpt_wave), one loop over pixels [p0, p1) (default the
    whole image) and the strata ``strata`` (ascending; None: every
    stratum): waves of whole strata of the range, or of
    pixel spans of one stratum where a stratum is over the memory budget.
    A PT wave (at most 2^22 rays, ``_wave_spp_batch``) is one
    ``path_trace_pixels_fast`` call; a BDPT wave (``_bdpt_wave_shape``) is
    ``jnp_raygen`` and one ``bdpt_fast`` call, or with ``bdpt_wave`` one
    ``bdpt_jnp`` call (the BDPT wave loop never launches the megakernel).
    Every draw is keyed by the absolute sample id and every pixel adds its
    strata in stratum order, so the image does not depend on the waves.
    Writes stratum-kind checkpoints of the "jnp" stream.  ``plain`` runs
    the kernels' plain versions on the card, for comparisons.  Returns
    (rays, shadow rays, extra int64[4])."""
    dev, dtype = scene.device, scene.dtype
    W, H = cc.width, cc.height
    p1 = W * H if p1 is None else p1
    npix = p1 - p0
    S = cfg.sqrt_spp
    spp_eff = S * S
    if strata is None:
        strata = range(spp_eff)
    if integrator == "pt":
        batch, span = _wave_spp_batch(npix, spp_eff), npix
    else:
        batch, span = _bdpt_wave_shape(npix, spp_eff, cfg.max_depth,
                                       integrator == "bdpt-mis", dtype)
    estimate = bdpt_jnp if bdpt_wave else bdpt_fast
    key = rng.prng_key(seed)
    acc = torch.zeros(6, dtype=torch.int64, device=dev)
    no_shadow = torch.zeros((), dtype=torch.int64, device=dev)
    strata = torch.as_tensor(strata, dtype=torch.int64).to(dev)
    for k0 in range(0, strata.numel(), batch):
        s_b = strata[k0:k0 + batch]
        b = s_b.numel()
        for q0 in range(p0, p1, span):
            n = min(span, p1 - q0)
            pix = (q0 + torch.arange(n, dtype=torch.int64, device=dev)).repeat(b)
            s = s_b.repeat_interleave(n)
            if integrator == "pt":
                rad, st = path_trace_pixels_fast(
                    scene, (pix % W).to(dtype), (pix // W).to(dtype), (s % S).to(dtype),
                    (s // S).to(dtype), pix * spp_eff + s, cc, key, cfg.max_depth,
                    plain=plain)
                st = (st.rays_traced, no_shadow, *st[1:])
            else:
                o, d, ray_ids = jnp_raygen(cc, pix, s, key, dtype)
                rad, st = estimate(scene, o, d, ray_ids, key, cfg.max_depth,
                                   mis=integrator == "bdpt-mis", ref_vis=cfg.ref_vis,
                                   plain=plain)
            rad = rad.to(dtype).reshape(b, n, 3)
            for k in range(b):  # stratum-order left fold
                fb[q0 - p0:q0 - p0 + n] += rad[k]
            acc += torch.stack(list(st))
        if bar:
            bar.update(b)
        if stratum_callback is not None:
            done = int(s_b[-1]) + 1
            stratum_callback(dict(
                framebuffer_sum=fb.cpu().numpy().reshape(H, W, 3).copy(),
                strata_done=done, units_done=done, unit_kind="stratum",
                seed=seed, stream="jnp",
            ))
    return acc[0], acc[1], acc[2:]


def _run_route(route, scene, cfg, cc, integrator, seed, fb, p0, p1, strata=None,
               chunk_size=None, units_done=0, bar=None, stratum_callback=None):
    """Pixels [p0, p1) of the image through the loop of ``route``, added
    into ``fb`` (their rows), after ``units_done`` chunks or strata of a
    checkpoint; the stratum routes take the strata ``strata`` (default
    those from ``units_done`` on).  Returns the int64[6] counters: rays,
    shadow rays, node visits, box hits, triangle tests, triangle hits."""
    if strata is not None and route not in ("strata", "bdpt_wave"):
        raise ValueError(f"a set of strata needs the stratum loop, not route {route!r}")
    if route == "wave":
        rays, extra = _render_wave(scene, cfg, cc, seed, fb, units_done, bar,
                                   stratum_callback, p0, p1)
        shadow = torch.zeros((), dtype=torch.int64, device=scene.device)
    elif route in ("strata", "bdpt_wave"):
        if strata is None:
            strata = range(units_done, cfg.sqrt_spp ** 2)
        rays, shadow, extra = _render_strata(
            scene, cfg, cc, integrator, seed, fb, strata, bar, stratum_callback,
            bdpt_wave=route == "bdpt_wave", p0=p0, p1=p1)
    else:
        chunk_size = min(chunk_size or default_chunk_size(p1 - p0), p1 - p0)
        rays, shadow, extra = _render_chunks(
            scene, cfg, cc, integrator, seed, fb, chunk_size, units_done, bar,
            stratum_callback, p0, p1)
    return torch.cat([rays.reshape(1), shadow.reshape(1), extra])


def counts_to_stats(counts, scene: SceneTensors, wall_seconds: float) -> RenderStats:
    """The RenderStats of a render's int64[6] counters (``_run_route``)."""
    return RenderStats(*(int(x) for x in counts.cpu()),
                       bvh_nodes_built=int(scene.bvh_skip.shape[0]) if scene.use_bvh else 0,
                       wall_seconds=wall_seconds)


def render_part(scene: SceneTensors, cfg: CameraConfig, seed: int, integrator: str,
                route: str, p0: int, p1: int, strata=None):
    """Pixels [p0, p1) of the render of ``cfg`` through ``route`` (``_route``
    of the whole image: a part never takes another route than the whole),
    and on the stratum routes only the strata ``strata`` (ascending; default
    all).  Every draw is keyed by the absolute id pix*spp + s and every
    pixel adds its strata in stratum order, so a part equals the same rows
    of ``render()`` to the bit.  Writes no checkpoint and copies nothing to
    the host.  Returns (framebuffer rows [p1 - p0, 3] on the scene's device,
    the int64[6] counters of ``_run_route``)."""
    cc = camera_constants(cfg, scene.dtype, scene.device)
    fb = torch.zeros((max(0, p1 - p0), 3), dtype=scene.dtype, device=scene.device)
    if p1 <= p0:
        return fb, torch.zeros(6, dtype=torch.int64, device=scene.device)
    return fb, _run_route(route, scene, cfg, cc, integrator, seed, fb, p0, p1, strata=strata)


def render(
    scene: SceneTensors,
    cfg: CameraConfig,
    seed: int = 0,
    integrator: Optional[str] = None,
    chunk_size: Optional[int] = None,
    progress: bool = False,
    resume: Optional[dict] = None,
    stratum_callback=None,
) -> RenderResult:
    """camera::render (src/camera.h:43-145) minus the PNG write, for PT,
    BDPT and BDPT-MIS on the scene's device, through the route ``_route``
    picks: pt_wave, the BDPT wave loop, the fused megakernels, or the
    stratum loop over the jnp estimators (``_render_strata``, which also
    runs the BDPT wave loop).

    ``resume``: optional checkpoint dict (framebuffer_sum, units_done and
    chunk_size of a chunk-kind one, which the fused loop writes and
    resumes, or strata_done of a stratum-kind one: stream "wave" for
    pt_wave, "jnp" for the stratum loop, as ``bpt_tpu``'s loops write them)
    to continue an interrupted render.  ``stratum_callback(state_dict)``
    fires after each completed chunk or batch of strata — the checkpoint
    hook (the name is ``bpt_tpu``'s)."""
    integrator = integrator or cfg.integrator
    route = _route(scene, cfg, integrator, resume)
    reason = _reject_reason(scene, cfg, integrator, route)
    if reason:
        raise NotImplementedError(f"bpt_tpu_torch cannot render this: {reason}")

    dev = scene.device
    cc = camera_constants(cfg, scene.dtype, dev)
    W, H = cc.width, cc.height
    npix = W * H
    S = cfg.sqrt_spp
    spp_eff = S * S
    if chunk_size is None:
        chunk_size = default_chunk_size(npix)
    chunk_size = min(chunk_size, npix)
    n_chunks = int(np.ceil(npix / chunk_size))

    chunks_done = strata_done = 0
    kind = _resume_kind(resume)
    done = int(resume.get("units_done", resume.get("strata_done", 0))) if kind else 0
    if route == "fused" and kind == "chunk":
        chunks_done = done
        ck = int(resume.get("chunk_size", 0))
        if ck and ck != chunk_size:
            raise ValueError(
                f"chunk-kind checkpoint was written with chunk_size={ck} "
                f"but this run would use {chunk_size}; pass "
                f"chunk_size={ck} to resume it")
    elif route in ("strata", "bdpt_wave") and kind == "chunk":  # bpt_tpu's words (render.py:819-828)
        raise ValueError(
            "chunk-kind checkpoint can only resume on the fused megakernel "
            "path (same backend/scene/config as the run that wrote it)")
    elif route in ("strata", "bdpt_wave") and _resume_stream(resume) == "wave":
        raise ValueError(
            "stratum checkpoint was written by the pt_wave/fused-parity RNG "
            "stream but this run would continue it on the jnp wavefront "
            "(different jitter stream; it writes checkpoints of the jnp stream) "
            "— resume on the configuration that wrote it, or restart")
    else:
        strata_done = done
    if resume:
        # a copy: the loop adds into fb in place
        fb = torch.tensor(np.asarray(resume["framebuffer_sum"]).reshape(npix, 3),
                          dtype=scene.dtype, device=dev)
    else:
        fb = torch.zeros((npix, 3), dtype=scene.dtype, device=dev)

    bar = None
    if progress:
        from bpt_tpu_torch.utils.progress import ProgressBar

        bar = ProgressBar(n_chunks - chunks_done if route == "fused"
                          else spp_eff - strata_done)

    t0 = time.monotonic()
    counts = _run_route(route, scene, cfg, cc, integrator, seed, fb, 0, npix,
                        chunk_size=chunk_size,
                        units_done=chunks_done if route == "fused" else strata_done,
                        bar=bar, stratum_callback=stratum_callback)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats = counts_to_stats(counts, scene, time.monotonic() - t0)
    if bar:
        bar.finish()
    return RenderResult(
        framebuffer_sum=fb.cpu().numpy().reshape(H, W, 3),
        samples_per_pixel=spp_eff,
        stats=stats,
        width=W,
        height=H,
    )


def render_resilient(
    scene: SceneTensors,
    cfg: CameraConfig,
    seed: int = 0,
    retries: int = 2,
    stratum_callback=None,
    **kw,
) -> RenderResult:
    """``bpt_tpu``'s elastic render (render.py:568-610): on a failure
    mid-render, ``render`` again from the last completed checkpoint unit
    (a chunk of the fused loop, a batch of strata of the others) instead
    of from the start.  Completed work is never redone, and a resumed
    render equals an uninterrupted one to the bit.  The count of attempts
    resets whenever ``units_done`` has grown since the previous failure,
    so a long render survives any number of widely spaced failures; it
    re-raises when no checkpoint exists yet or ``retries`` failures in a
    row made no progress.  ``stratum_callback`` still sees every unit.

    This covers failures that leave the process able to launch again (an
    exception in a call).  A CUDA fault that poisons the context, such as
    an illegal address, cannot be retried in the process, as a poisoned
    TPU client cannot in ``bpt_tpu``: it needs a process restart and the
    on-disk checkpoint (``utils/checkpoint.py``, the CLI's
    ``--checkpoint``)."""
    last: dict = {}

    def cb(snap):
        last.clear()
        last.update(snap)
        if stratum_callback is not None:
            stratum_callback(snap)

    caller_resume = kw.pop("resume", None)
    attempt = 0
    done_at_last_failure = -1
    while True:
        try:
            return render(scene, cfg, seed=seed,
                          resume=dict(last) if last else caller_resume,
                          stratum_callback=cb, **kw)
        except Exception:
            done = int(last.get("units_done", 0)) if last else 0
            if done > done_at_last_failure:
                attempt = 0  # progress since the previous failure
            done_at_last_failure = done
            attempt += 1
            if attempt > retries or not last:
                raise
