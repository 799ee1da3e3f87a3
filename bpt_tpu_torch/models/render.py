"""Render loop: the chunked fused-megakernel loop of
``bpt_tpu.models.render`` for PT and BDPT (render.py:157-224, 759-817),
and its two large-scene loops: the spp-batched ``pt_wave`` loop for PT
(render.py:243-368, 665-712) and the jnp-stream BDPT wave loop for bdpt and
bdpt-mis (render.py:371-497, 713-755).

Each chunk of pixels is one ``pt_megakernel_pixels`` call (integrator pt)
or one ``bdpt_megakernel_pixels`` call (bdpt, bdpt-mis) that runs every
sample stratum of those pixels; the framebuffer is a running sum, which
gives free checkpoint/resume at chunk granularity.  A render of a scene
over 512 triangles instead runs batches of sample strata over the whole
image, with stratum checkpoints: PT through ``pt_wave``, BDPT through
``models.bdpt.bdpt_fast``, whose traversals launch the BVH kernels.  Every
draw is keyed by the absolute sample id pix*spp + s, so the image depends
neither on the chunk size nor on the batch.  On a CUDA scene the loops run
the CUDA kernels; on a CPU scene they run the kernels' plain versions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.models.bdpt import bdpt_fast
from bpt_tpu_torch.models.camera import camera_constants, generate_rays
from bpt_tpu_torch.ops.film import to_rgb8
from bpt_tpu_torch.ops.kernels.bdpt_kernel import MAX_DEPTH, bdpt_megakernel_pixels
from bpt_tpu_torch.ops.kernels.pt_kernel import (
    MAX_TRIS,
    camera_table,
    megakernel_reject_reason,
    pt_megakernel_pixels,
    shade_reject_reason,
)
from bpt_tpu_torch.ops.kernels.pt_wave import pt_wave
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
# BYTES_PER_RAY[mis] = (per S^2, per S, constant).  The least-squares fit of
# torch.cuda.max_memory_allocated over coffee waves of 65,536 rays at S = 2,
# 5, 10, 20, 40 and 80 on an H100 (tools/probe_bdpt_wave_memory.py; PERF.md,
# the coffee BDPT cells) was 409.3 S + 141.4 without MIS and 10.68 S^2 +
# 380.4 S + 933.0 with it, within 4% of every point; these lie 8-32% above
# every point, and 7% above the 512x512 / 4 spp / depth 10 bdpt-mis render's
# one 2^20-ray wave (6.19 GiB).  A wave holds as many rays as keep
# that peak under BDPT_WAVE_BYTES, under a third of the card's 80 GB, which
# leaves room for the allocator's slack and the caller's tensors; the
# 512x512 / 4 spp / depth 80 bdpt-mis render, split into pixel ranges,
# peaked at 18.2 GiB.
BYTES_PER_RAY = {False: (0, 470, 160), True: (15, 440, 900)}
BDPT_WAVE_BYTES = 24 << 30


def _uses_wave(scene: SceneTensors, integrator: str) -> bool:
    """PT on a scene over 512 triangles takes pt_wave at every image size
    (bpt_tpu sends such renders under 2^18 pixels to its clustered fused
    megakernel, which is not ported: ROADMAP §3)."""
    return integrator == "pt" and scene.num_tris > MAX_TRIS


def _uses_bdpt_wave(scene: SceneTensors, integrator: str) -> bool:
    """BDPT on a scene over 512 triangles takes the jnp-stream wave loop at
    every image size and depth (bpt_tpu sends such renders under 2^18
    samples or past depth 32 to its clustered fused megakernel, which is not
    ported: ROADMAP §3)."""
    return integrator in ("bdpt", "bdpt-mis") and scene.num_tris > MAX_TRIS


def _bdpt_wave_reject_reason(scene: SceneTensors) -> str:
    if scene.device.type == "cuda":
        return shade_reject_reason(scene)  # the BVH kernels' tables
    if scene.num_volumes or scene.has_textures:
        return "scene has volumes or textures (not yet ported: ROADMAP §1 item 8)"
    return ""


def _reject_reason(scene: SceneTensors, cfg: CameraConfig, integrator: str) -> str:
    bdpt_wave = _uses_bdpt_wave(scene, integrator)
    if _uses_wave(scene, integrator):
        reason = shade_reject_reason(scene)
    elif bdpt_wave:
        reason = _bdpt_wave_reject_reason(scene)
    else:
        reason = megakernel_reject_reason(scene, integrator)
    if not reason and integrator != "pt" and not 1 <= cfg.max_depth <= MAX_DEPTH:
        reason = (f"BDPT max_depth {cfg.max_depth} outside 1..{MAX_DEPTH}, the "
                  "CUDA kernel's vertex-scratch bound")
    if not reason and cfg.defocus_angle > 0.0 and not bdpt_wave:
        reason = ("defocus camera (only the large-scene BDPT route draws the "
                  "disk yet: ROADMAP §0 step 2)")
    return reason


def _bdpt_wave_shape(npix: int, spp_eff: int, depth: int, mis: bool) -> tuple[int, int]:
    """(strata per wave, pixels per wave): as many whole strata of the
    image as keep a wave's peak memory under BDPT_WAVE_BYTES (bpt_tpu's
    _bdpt_wave_batch, on the port's own measured bytes), else one stratum
    in ranges of as many pixels as do."""
    a, b, c = BYTES_PER_RAY[mis]
    S = max(1, depth)
    cap = max(1, BDPT_WAVE_BYTES // (a * S * S + b * S + c))
    if cap >= npix:
        return min(spp_eff, cap // npix), npix
    return 1, cap


def _render_chunks(scene, cfg, cc, integrator, seed, fb, chunk_size,
                   chunks_done, bar, stratum_callback):
    """The fused loop: each chunk of pixels is one megakernel call that runs
    all its strata.  Returns (rays, shadow rays, extra int64[4])."""
    dev = scene.device
    W, H = cc.width, cc.height
    npix = W * H
    S = cfg.sqrt_spp
    n_chunks = int(np.ceil(npix / chunk_size))
    key = rng.prng_key(seed)
    cam = camera_table(cc)
    rays_acc = torch.zeros((), dtype=torch.int64, device=dev)
    shadow_acc = torch.zeros((), dtype=torch.int64, device=dev)
    extra_acc = torch.zeros(4, dtype=torch.int64, device=dev)
    for c in range(chunks_done, n_chunks):
        pix = c * chunk_size + torch.arange(chunk_size, dtype=torch.int64, device=dev)
        in_range = pix < npix
        pixc = torch.clamp_max(pix, npix - 1)
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
        n = min(chunk_size, npix - c * chunk_size)
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


def _render_wave(scene, cfg, cc, seed, fb, strata_done, bar, stratum_callback):
    """bpt_tpu's pt_wave loop (render.py:665-712 over _make_step_pt_wave):
    batches of strata over the whole image, each one pt_wave call, added
    to the framebuffer in stratum order.  Returns (rays, extra int64[4])."""
    dev, dtype = scene.device, scene.dtype
    W, H = cc.width, cc.height
    npix = W * H
    S = cfg.sqrt_spp
    spp_eff = S * S
    batch = _wave_spp_batch(npix, spp_eff)
    key = rng.prng_key(seed)
    key_pt = rng.fold_in(key, 1)
    pix = torch.arange(npix, dtype=torch.int64, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    extra = torch.zeros(4, dtype=torch.int64, device=dev)
    s_lin = strata_done
    while s_lin < spp_eff:
        b = min(batch, spp_eff - s_lin)
        i = (pix % W).to(dtype).repeat(b)
        j = (pix // W).to(dtype).repeat(b)
        s = s_lin + torch.arange(b, device=dev).repeat_interleave(npix)
        ray_ids = pix.repeat(b) * spp_eff + s
        u0, u1 = rng.raygen_jitter(key, ray_ids)
        zero = torch.zeros_like(u0)
        o3, d3 = generate_rays(cc, i, j, (s % S).to(dtype), (s // S).to(dtype),
                               torch.stack([u0, u1, zero, zero], -1).to(dtype))
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


def _render_bdpt_wave(scene, cfg, cc, integrator, seed, fb, strata_done, bar,
                      stratum_callback, plain: bool = False):
    """bpt_tpu's large-scene BDPT loop (render.py:713-755 over
    _make_step_bdpt_wave): waves of whole strata of the image, or of pixel
    ranges of one stratum where a stratum is over the memory budget, each
    one ``bdpt_fast`` call on the jnp stream after ``jnp_raygen``; every
    pixel adds its strata in stratum order.  ``plain`` walks
    the BVH in torch, for comparisons on the card.  Returns (rays, shadow
    rays, extra int64[4])."""
    dev, dtype = scene.device, scene.dtype
    W, H = cc.width, cc.height
    npix = W * H
    S = cfg.sqrt_spp
    spp_eff = S * S
    batch, span = _bdpt_wave_shape(npix, spp_eff, cfg.max_depth, integrator == "bdpt-mis")
    key = rng.prng_key(seed)
    acc = torch.zeros(6, dtype=torch.int64, device=dev)
    s_lin = strata_done
    while s_lin < spp_eff:
        b = min(batch, spp_eff - s_lin)
        for p0 in range(0, npix, span):
            n = min(span, npix - p0)
            pix = (p0 + torch.arange(n, dtype=torch.int64, device=dev)).repeat(b)
            s = s_lin + torch.arange(b, device=dev).repeat_interleave(n)
            o, d, ray_ids = jnp_raygen(cc, pix, s, key, dtype)
            rad, st = bdpt_fast(scene, o, d, ray_ids, key, cfg.max_depth,
                                mis=integrator == "bdpt-mis", plain=plain)
            rad = rad.reshape(b, n, 3)
            for k in range(b):  # stratum-order left fold
                fb[p0:p0 + n] += rad[k]
            acc += torch.stack(list(st))
        s_lin += b
        if bar:
            bar.update(b)
        if stratum_callback is not None:
            stratum_callback(dict(
                framebuffer_sum=fb.cpu().numpy().reshape(H, W, 3).copy(),
                strata_done=s_lin, units_done=s_lin, unit_kind="stratum",
                seed=seed, stream="jnp",
            ))
    return acc[0], acc[1], acc[2:]


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
    BDPT and BDPT-MIS on the fused megakernels, and on large scenes for PT
    through pt_wave and for BDPT through the jnp-stream wave loop, on the
    scene's device.

    ``resume``: optional checkpoint dict (framebuffer_sum, units_done and
    chunk_size of a chunk-kind one, or strata_done of a stratum-kind one
    written by a wave loop: stream "wave" for pt_wave, "jnp" for BDPT, as
    ``bpt_tpu``'s loops write them) to continue an interrupted render.
    ``stratum_callback(state_dict)`` fires after each completed chunk or
    batch of strata — the checkpoint hook (the name is ``bpt_tpu``'s)."""
    integrator = integrator or cfg.integrator
    reason = _reject_reason(scene, cfg, integrator)
    if reason:
        raise NotImplementedError(f"bpt_tpu_torch cannot render this: {reason}")
    wave = _uses_wave(scene, integrator)
    bdpt_wave = _uses_bdpt_wave(scene, integrator)

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
    if (wave or bdpt_wave) and kind:
        stream = "wave" if wave else "jnp"
        if kind != "stratum" or resume.get("stream", "") not in ("", stream):
            raise ValueError(
                f"a {kind}-kind checkpoint (stream {resume.get('stream', '')!r}) "
                f"cannot resume the {'pt_wave' if wave else 'BDPT wave'} loop, "
                f"which writes stratum-kind checkpoints of the {stream} stream")
        strata_done = int(resume.get("units_done", resume.get("strata_done", 0)))
    elif kind == "chunk":
        chunks_done = int(resume.get("units_done", resume.get("strata_done", 0)))
        ck = int(resume.get("chunk_size", 0))
        if ck and ck != chunk_size:
            raise ValueError(
                f"chunk-kind checkpoint was written with chunk_size={ck} "
                f"but this run would use {chunk_size}; pass "
                f"chunk_size={ck} to resume it")
    elif kind:
        raise ValueError(
            f"a {kind}-kind checkpoint cannot resume the fused chunk loop of a "
            "scene of at most 512 triangles (bpt_tpu's jnp stratum loop for "
            "such scenes is not ported yet: ROADMAP §0 step 2)")
    if resume:
        # a copy: the loop adds into fb in place
        fb = torch.tensor(np.asarray(resume["framebuffer_sum"]).reshape(npix, 3),
                          dtype=scene.dtype, device=dev)
    else:
        fb = torch.zeros((npix, 3), dtype=scene.dtype, device=dev)

    bar = None
    if progress:
        from bpt_tpu_torch.utils.progress import ProgressBar

        bar = ProgressBar(spp_eff - strata_done if wave or bdpt_wave
                          else n_chunks - chunks_done)

    stats = RenderStats()
    stats.bvh_nodes_built = int(scene.bvh_skip.shape[0]) if scene.use_bvh else 0
    t0 = time.monotonic()
    shadow_acc = 0
    if wave:
        rays_acc, extra_acc = _render_wave(scene, cfg, cc, seed, fb, strata_done,
                                           bar, stratum_callback)
    elif bdpt_wave:
        rays_acc, shadow_acc, extra_acc = _render_bdpt_wave(
            scene, cfg, cc, integrator, seed, fb, strata_done, bar, stratum_callback)
    else:
        rays_acc, shadow_acc, extra_acc = _render_chunks(
            scene, cfg, cc, integrator, seed, fb, chunk_size, chunks_done, bar,
            stratum_callback)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats.wall_seconds = time.monotonic() - t0
    stats.rays_traced = int(rays_acc)
    stats.shadow_rays = int(shadow_acc)
    nv, ah, tt, th = (int(x) for x in extra_acc.cpu())
    stats.bvh_node_visits, stats.aabb_hits = nv, ah
    stats.triangle_tests, stats.triangle_hits = tt, th
    if bar:
        bar.finish()
    return RenderResult(
        framebuffer_sum=fb.cpu().numpy().reshape(H, W, 3),
        samples_per_pixel=spp_eff,
        stats=stats,
        width=W,
        height=H,
    )
