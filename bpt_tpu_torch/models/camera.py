"""Camera constants + vectorized primary-ray generation.

camera::initialize (src/camera.h:160-197) runs once on host in float64
into a small set of tensors; get_ray / sample_square_stratified /
defocus_disk_sample (camera.h:199-234) become one batched function over
(pixel, stratum) grids — counterpart of ``bpt_tpu.models.camera``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from bpt_tpu_torch.core.sampling import unit_disk_point
from bpt_tpu_torch.scene.types import CameraConfig


@dataclass(frozen=True)
class CameraConstants:
    center: torch.Tensor  # [3]
    pixel00: torch.Tensor  # [3]
    du: torch.Tensor  # [3] pixel delta right
    dv: torch.Tensor  # [3] pixel delta down
    defocus_u: torch.Tensor  # [3]
    defocus_v: torch.Tensor  # [3]
    width: int = 0
    height: int = 0
    sqrt_spp: int = 1
    defocus: bool = False
    ref_vis: bool = False  # CameraConfig.ref_vis


def camera_constants(cfg: CameraConfig, dtype=torch.float32,
                     device="cpu") -> CameraConstants:
    """camera::initialize (camera.h:160-197), float64 host math."""
    w = cfg.image_width
    h = cfg.image_height

    lookfrom = np.asarray(cfg.lookfrom, np.float64)
    lookat = np.asarray(cfg.lookat, np.float64)
    vup = np.asarray(cfg.vup, np.float64)

    theta = math.radians(cfg.vfov)
    hh = math.tan(theta / 2.0)
    viewport_height = 2.0 * hh * cfg.focus_dist
    viewport_width = viewport_height * (w / h)

    wv = lookfrom - lookat
    wv = wv / np.linalg.norm(wv)
    uv = np.cross(vup, wv)
    uv = uv / np.linalg.norm(uv)
    vv = np.cross(wv, uv)

    viewport_u = viewport_width * uv
    viewport_v = viewport_height * -vv
    du = viewport_u / w
    dv = viewport_v / h
    upper_left = lookfrom - cfg.focus_dist * wv - viewport_u / 2 - viewport_v / 2
    pixel00 = upper_left + 0.5 * (du + dv)

    defocus_radius = cfg.focus_dist * math.tan(math.radians(cfg.defocus_angle / 2.0))

    def ten(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return CameraConstants(
        center=ten(lookfrom),
        pixel00=ten(pixel00),
        du=ten(du),
        dv=ten(dv),
        defocus_u=ten(uv * defocus_radius),
        defocus_v=ten(vv * defocus_radius),
        width=w,
        height=h,
        sqrt_spp=cfg.sqrt_spp,
        defocus=cfg.defocus_angle > 0.0,
        ref_vis=cfg.ref_vis,
    )


def generate_rays(cc: CameraConstants, i, j, s_i, s_j, uniforms):
    """get_ray (camera.h:199-213) batched.

    i, j: pixel coords [N]; s_i, s_j: stratum indices [N];
    uniforms: [N,4] — (jitter x, jitter y, disk u1, disk u2).
    Returns (origins [N,3], directions [N,3] — unnormalized, as in the
    reference).
    """
    recip = 1.0 / cc.sqrt_spp
    ox = (s_i + uniforms[..., 0]) * recip - 0.5
    oy = (s_j + uniforms[..., 1]) * recip - 0.5
    pixel_sample = (
        cc.pixel00
        + (i + ox)[..., None] * cc.du
        + (j + oy)[..., None] * cc.dv
    )
    if cc.defocus:
        disk = unit_disk_point(uniforms[..., 2], uniforms[..., 3])
        origin = (
            cc.center
            + disk[..., 0:1] * cc.defocus_u
            + disk[..., 1:2] * cc.defocus_v
        )
    else:
        origin = torch.broadcast_to(cc.center, pixel_sample.shape)
    return origin, pixel_sample - origin
