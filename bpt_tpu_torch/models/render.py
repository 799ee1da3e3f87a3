"""Render loop: the chunked fused-megakernel loop of
``bpt_tpu.models.render`` for PT and BDPT (render.py:157-224, 759-817).

Each chunk of pixels is one ``pt_megakernel_pixels`` call (integrator pt)
or one ``bdpt_megakernel_pixels`` call (bdpt, bdpt-mis) that runs every
sample stratum of those pixels; the framebuffer is a running sum, which
gives free checkpoint/resume at chunk granularity.  Every draw is keyed by
the absolute sample id pix*spp + s, so the image does not depend on the
chunk size.  On a CUDA scene the chunk runs the CUDA kernel; on a CPU
scene it runs the kernel's plain version.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.ops.film import to_rgb8
from bpt_tpu_torch.ops.kernels.bdpt_kernel import MAX_DEPTH, bdpt_megakernel_pixels
from bpt_tpu_torch.ops.kernels.pt_kernel import (
    camera_table,
    megakernel_reject_reason,
    pt_megakernel_pixels,
)
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
    BDPT and BDPT-MIS on the fused megakernels, on the scene's device.

    ``resume``: optional chunk-kind checkpoint dict (framebuffer_sum,
    units_done, chunk_size) to continue an interrupted render.
    ``stratum_callback(state_dict)`` fires after each completed chunk — the
    checkpoint hook (the name is ``bpt_tpu``'s)."""
    integrator = integrator or cfg.integrator
    reason = megakernel_reject_reason(scene, integrator)
    if not reason and integrator != "pt" and not 1 <= cfg.max_depth <= MAX_DEPTH:
        reason = (f"BDPT max_depth {cfg.max_depth} outside 1..{MAX_DEPTH}, the "
                  "CUDA kernel's vertex-scratch bound")
    if not reason and cfg.defocus_angle > 0.0:
        reason = ("defocus camera (needs the wavefront raygen route: "
                  "ROADMAP §1 item 2)")
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

    chunks_done = 0
    kind = _resume_kind(resume)
    if kind == "chunk":
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

        bar = ProgressBar(n_chunks - chunks_done)

    key = rng.prng_key(seed)
    cam = camera_table(cc)
    stats = RenderStats()
    rays_acc = torch.zeros((), dtype=torch.int64, device=dev)
    shadow_acc = torch.zeros((), dtype=torch.int64, device=dev)
    extra_acc = torch.zeros(4, dtype=torch.int64, device=dev)
    t0 = time.monotonic()
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
                spp_loop=spp_eff, sqrt_spp=S,
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
