"""Render loop: the chunked fused-megakernel loop of
``bpt_tpu.models.render`` for PT and BDPT (render.py:157-224, 759-817),
and its spp-batched ``pt_wave`` loop for PT on large scenes
(render.py:243-368, 665-712).

Each chunk of pixels is one ``pt_megakernel_pixels`` call (integrator pt)
or one ``bdpt_megakernel_pixels`` call (bdpt, bdpt-mis) that runs every
sample stratum of those pixels; the framebuffer is a running sum, which
gives free checkpoint/resume at chunk granularity.  A PT render of a scene
over 512 triangles instead runs batches of sample strata over the whole
image through ``pt_wave``, with stratum checkpoints.  Every draw is keyed
by the absolute sample id pix*spp + s, so the image depends neither on the
chunk size nor on the batch.  On a CUDA scene the loops run the CUDA
kernels; on a CPU scene they run the kernels' plain versions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core import vec3 as v3
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


def _uses_wave(scene: SceneTensors, integrator: str) -> bool:
    """PT on a scene over 512 triangles takes pt_wave at every image size
    (bpt_tpu sends such renders under 2^18 pixels to its clustered fused
    megakernel, which is not ported: ROADMAP §3)."""
    return integrator == "pt" and scene.num_tris > MAX_TRIS


def _reject_reason(scene: SceneTensors, cfg: CameraConfig, integrator: str) -> str:
    if _uses_wave(scene, integrator):
        reason = shade_reject_reason(scene)
    elif integrator != "pt" and scene.num_tris > MAX_TRIS:
        reason = (f"{integrator} on a scene of {scene.num_tris} triangles needs "
                  "the clustered any-hit (Pallas kernel 8) and the jnp stream, "
                  "which are not yet ported (ROADMAP §0 step 1)")
    else:
        reason = megakernel_reject_reason(scene, integrator)
    if not reason and integrator != "pt" and not 1 <= cfg.max_depth <= MAX_DEPTH:
        reason = (f"BDPT max_depth {cfg.max_depth} outside 1..{MAX_DEPTH}, the "
                  "CUDA kernel's vertex-scratch bound")
    if not reason and cfg.defocus_angle > 0.0:
        reason = ("defocus camera (needs the wavefront raygen route: "
                  "ROADMAP §1 item 2)")
    return reason


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


def _render_wave(scene, cfg, cc, seed, fb, strata_done, bar, stratum_callback,
                 paged=None):
    """bpt_tpu's pt_wave loop (render.py:665-712 over _make_step_pt_wave):
    batches of strata over the whole image, each one pt_wave call, added
    to the framebuffer in stratum order.  ``paged`` goes to pt_wave (None:
    its own rule).  Returns (rays, extra int64[4])."""
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
                                   ray_ids.to(torch.int32), key_pt, cfg.max_depth,
                                   paged=paged)
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
    BDPT and BDPT-MIS on the fused megakernels and for PT on large scenes
    through pt_wave, on the scene's device.

    ``resume``: optional checkpoint dict (framebuffer_sum, units_done and
    chunk_size of a chunk-kind one, or strata_done of a stratum-kind one
    written by the pt_wave loop) to continue an interrupted render.
    ``stratum_callback(state_dict)`` fires after each completed chunk or
    batch of strata — the checkpoint hook (the name is ``bpt_tpu``'s)."""
    integrator = integrator or cfg.integrator
    reason = _reject_reason(scene, cfg, integrator)
    if reason:
        raise NotImplementedError(f"bpt_tpu_torch cannot render this: {reason}")
    wave = _uses_wave(scene, integrator)

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
    if wave and kind:
        if kind != "stratum" or resume.get("stream", "") not in ("", "wave"):
            raise ValueError(
                f"a {kind}-kind checkpoint (stream {resume.get('stream', '')!r}) "
                "cannot resume the pt_wave loop, which writes stratum-kind "
                "checkpoints of the wave stream")
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
            f"{kind}-kind checkpoints come from bpt_tpu's stratum loops, which "
            "bpt_tpu_torch does not run yet (ROADMAP §1 item 6)")
    if resume:
        # a copy: the loop adds into fb in place
        fb = torch.tensor(np.asarray(resume["framebuffer_sum"]).reshape(npix, 3),
                          dtype=scene.dtype, device=dev)
    else:
        fb = torch.zeros((npix, 3), dtype=scene.dtype, device=dev)

    bar = None
    if progress:
        from bpt_tpu_torch.utils.progress import ProgressBar

        bar = ProgressBar(spp_eff - strata_done if wave else n_chunks - chunks_done)

    stats = RenderStats()
    stats.bvh_nodes_built = int(scene.bvh_skip.shape[0]) if scene.use_bvh else 0
    t0 = time.monotonic()
    shadow_acc = 0
    if wave:
        rays_acc, extra_acc = _render_wave(scene, cfg, cc, seed, fb, strata_done,
                                           bar, stratum_callback)
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
