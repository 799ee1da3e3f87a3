"""Rendering over several devices: ``bpt_tpu.parallel.mesh`` on a list of
torch devices.

A mesh is a list of ``torch.device``; entries may repeat (``[cuda:0] * 4``
on a one-card host, ``[cpu] * 8`` in the tests).  Two ways to split an
image, as in ``bpt_tpu``:

* **pixel sharding** (``render_distributed``): device d renders the d-th
  contiguous range of ``ceil(npix / n)`` pixels with every stratum, through
  the route the whole image takes (``models.render.render_part``), and the
  ranges are joined in order.  Every draw is keyed by the absolute id
  pix*spp + s and every pixel adds its strata in order, so the image and
  the summed counters equal ``render()``'s to the bit at any mesh size.
* **sample sharding** (``render_spp_sharded``): device d renders stratum
  s0 + d of every pixel on the stratum loop, and the parts are summed: in
  device order in one process, with ``dist.all_reduce`` across a process
  group.  Equal up to the order of float additions.

``render_distributed_2d`` combines both over a (host, chip) mesh.  The
scene is copied to each other device of the mesh once (``scene_on``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from bpt_tpu_torch.models.render import (
    UNROLL_MAX,
    _reject_reason,
    _route,
    counts_to_stats,
    render_part,
)
from bpt_tpu_torch.ops.kernels.pt_kernel import megakernel_reject_reason, shade_reject_reason
from bpt_tpu_torch.scene.types import (
    CameraConfig,
    SceneTensors,
    per_scene,
    scene_from_numpy,
    scene_to_numpy,
)

FAST = ("auto", "always", "never", "wave")


def _device(d) -> torch.device:
    """``d`` as a torch.device with its card's index; raises for a card
    this host does not have."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev}: CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {dev}: this host has "
                               f"{torch.cuda.device_count()} card(s)")
    return dev


def make_mesh(n_devices: Optional[int] = None, devices=None) -> list:
    """The mesh: ``devices`` (default every visible card), the first
    ``n_devices`` of them.  Without ``devices`` on a host with no card it
    raises; CPU meshes are asked for by name (``[torch.device("cpu")] * n``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices="
                               "[torch.device('cpu')] * n to shard over the CPU")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, {len(devices)} given")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: an empty mesh")
    return devices


def shard_route(scene: SceneTensors, cfg: CameraConfig, integrator: str, fast: str) -> str:
    """The route every shard takes (``models.render._route``'s names) for
    ``bpt_tpu``'s ``fast`` switch (mesh.py:480-517): ``"auto"`` the route
    ``render()`` takes, ``"always"`` the fused loop, ``"never"`` the stratum
    loop, ``"wave"`` ``pt_wave`` for PT and the BDPT wave loop for BDPT.
    Raises where the route cannot render the configuration."""
    if fast not in FAST:
        raise ValueError(f"fast must be 'auto'|'always'|'never'|'wave', got {fast!r}")
    if fast == "auto":
        route = _route(scene, cfg, integrator, None)
    elif fast == "never":
        route = "strata"
    elif fast == "always":
        route = "fused"
        reason = megakernel_reject_reason(scene, integrator)
        if not reason and (cfg.defocus_angle > 0.0 or cfg.ref_vis):
            reason = "the fused loop renders neither defocus nor ref_vis"
        if reason:
            raise NotImplementedError(f"bpt_tpu_torch cannot render this with "
                                      f"fast='always': {reason}")
    elif integrator == "pt":
        route = "wave"
        reason = shade_reject_reason(scene)
        if reason:
            raise NotImplementedError(f"bpt_tpu_torch cannot render this with "
                                      f"fast='wave': {reason}")
    else:
        if cfg.max_depth > UNROLL_MAX:
            raise ValueError("fast='wave' BDPT requires max_depth <= UNROLL_MAX "
                             "(docs/PARITY.md deviation 10)")
        route = "bdpt_wave"
    reason = _reject_reason(scene, cfg, integrator, route)
    if reason:
        raise NotImplementedError(f"bpt_tpu_torch cannot render this: {reason}")
    return route


def shard_range(npix: int, n: int, d: int) -> tuple[int, int]:
    """Pixels [p0, p1) of shard d of n: contiguous shards of ceil(npix / n)
    pixels over the image padded to a multiple of n; the last shards may
    hold fewer in-range pixels, or none."""
    m = -(-npix // n)
    return min(d * m, npix), min((d + 1) * m, npix)


@per_scene
def _copies(scene: SceneTensors) -> dict:
    """The scene's copies on other devices, by device, kept while it lives."""
    return {}


def scene_on(scene: SceneTensors, dev: torch.device) -> SceneTensors:
    """``scene`` on ``dev``: itself, or its copy there (``scene_to_numpy`` /
    ``scene_from_numpy``), made on first use and kept while the scene
    lives, so a copy's packed tables are kept too."""
    if dev == scene.device:
        return scene
    copies = _copies(scene)
    if dev not in copies:
        copies[dev] = scene_from_numpy(*scene_to_numpy(scene), device=dev, dtype=scene.dtype)
    return copies[dev]


def render_distributed(scene: SceneTensors, cfg: CameraConfig, mesh=None, seed: int = 0,
                       integrator: Optional[str] = None, fast: str = "auto"):
    """The pixel-sharded render over ``mesh`` (default ``make_mesh()``):
    device d renders shard d (``shard_range``) through ``shard_route`` and
    the shards are joined in order.  Every shard is launched before the
    first copy to the host, so the devices of a card mesh overlap.

    Returns (framebuffer sum [H, W, 3] numpy, spp_eff, RenderStats): image
    and counters equal to ``render()``'s on the same route, to the bit."""
    mesh = make_mesh() if mesh is None else make_mesh(devices=mesh)
    integrator = integrator or cfg.integrator
    route = shard_route(scene, cfg, integrator, fast)
    W, H = cfg.image_width, cfg.image_height
    npix = W * H
    t0 = time.monotonic()
    parts = [render_part(scene_on(scene, dev), cfg, seed, integrator, route,
                         *shard_range(npix, len(mesh), d))
             for d, dev in enumerate(mesh)]
    fb = np.concatenate([f.cpu().numpy() for f, _ in parts]).reshape(H, W, 3)
    counts = sum(c.cpu() for _, c in parts)
    return fb, cfg.sqrt_spp ** 2, counts_to_stats(counts, scene, time.monotonic() - t0)


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the process group: on the host under gloo, on the
    rank's card under nccl."""
    comm = t.cpu() if dist.get_backend() == "gloo" else t
    dist.all_reduce(comm)
    return comm.to(t.device)


def render_spp_sharded(scene: SceneTensors, cfg: CameraConfig, mesh=None, seed: int = 0,
                       s0: int = 0, integrator: Optional[str] = None):
    """One batch of sample strata (``bpt_tpu``'s ``render_spp_sharded_step``,
    mesh.py:114-141): device d of the mesh renders stratum s0 + d of every
    pixel on the stratum loop (the jnp stream; on the card its estimators
    launch the megakernels in rays or pixels mode, or the hit kernels), a
    stratum past spp_eff adds zero, and the parts are summed in device
    order.  Under a process group, rank r's devices render strata
    s0 + r * len(mesh) + d and the ranks' sums are added with
    ``dist.all_reduce``.  Loop s0 over range(0, spp_eff, devices in all) for
    a whole image.

    Returns (the batch's framebuffer sum [H, W, 3] numpy, RenderStats)."""
    mesh = make_mesh() if mesh is None else make_mesh(devices=mesh)
    integrator = integrator or cfg.integrator
    route = shard_route(scene, cfg, integrator, "never")
    W, H = cfg.image_width, cfg.image_height
    spp_eff = cfg.sqrt_spp ** 2
    first = s0 + (dist.get_rank() * len(mesh) if dist.is_initialized() else 0)
    t0 = time.monotonic()
    parts = [render_part(scene_on(scene, dev), cfg, seed, integrator, route, 0, W * H,
                         strata=[first + d] if first + d < spp_eff else [])
             for d, dev in enumerate(mesh)]
    fb, counts = parts[0]
    for f, c in parts[1:]:
        fb = fb + f.to(fb.device)
        counts = counts + c.to(counts.device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        fb, counts = _all_reduce(fb), _all_reduce(counts)
    fb = fb.cpu().numpy().reshape(H, W, 3)
    return fb, counts_to_stats(counts, scene, time.monotonic() - t0)


def make_mesh_2d(n_hosts: int, chips_per_host: int, devices=None) -> list:
    """A (host, chip) mesh, ``bpt_tpu``'s multi-host shape (mesh.py:365-375):
    ``n_hosts`` rows of ``chips_per_host`` devices cut from ``devices``
    (default every visible card)."""
    flat = make_mesh(n_hosts * chips_per_host, devices)
    return [flat[h * chips_per_host:(h + 1) * chips_per_host] for h in range(n_hosts)]


def render_distributed_2d(scene: SceneTensors, cfg: CameraConfig, mesh, seed: int = 0,
                          integrator: Optional[str] = None):
    """The full render over a (host, chip) mesh (``bpt_tpu``'s
    render_distributed_2d, mesh.py:379-444): pixels sharded over the chips,
    strata over the hosts, the hosts' parts of a batch of strata summed in
    host order and added into each chip's shard.  On the stratum loop;
    equal to it up to the float addition order of the strata.

    Returns (framebuffer sum [H, W, 3] numpy, spp_eff, RenderStats)."""
    integrator = integrator or cfg.integrator
    mesh = [make_mesh(devices=row) for row in mesh]
    n_hosts, n_chips = len(mesh), len(mesh[0])
    route = shard_route(scene, cfg, integrator, "never")
    W, H = cfg.image_width, cfg.image_height
    npix, spp_eff = W * H, cfg.sqrt_spp ** 2
    t0 = time.monotonic()
    shards, counts = [], torch.zeros(6, dtype=torch.int64)
    for c in range(n_chips):
        p0, p1 = shard_range(npix, n_chips, c)
        fb_c = torch.zeros((p1 - p0, 3), dtype=scene.dtype, device=mesh[0][c])
        for s0 in range(0, spp_eff, n_hosts):
            batch = torch.zeros_like(fb_c)
            for h in range(n_hosts):
                s = s0 + h
                part, cnt = render_part(scene_on(scene, mesh[h][c]), cfg, seed, integrator, route,
                                        p0, p1, strata=[s] if s < spp_eff else [])
                batch = batch + part.to(batch.device)
                counts += cnt.cpu()
            fb_c += batch
        shards.append(fb_c)
    fb = np.concatenate([f.cpu().numpy() for f in shards]).reshape(H, W, 3)
    return fb, spp_eff, counts_to_stats(counts, scene, time.monotonic() - t0)
