"""Batched direction/point sampling: the reference's rejection loops
(src/core/vec3.h:113-128) as analytic polar sampling, the same closed forms
as ``bpt_tpu.core.sampling``."""

from __future__ import annotations

import torch

from bpt_tpu_torch.core import vecmath as vm
from bpt_tpu_torch.core.onb import onb_from_w, onb_transform

PI = vm.PI
SPHERE_PDF = 1.0 / (4.0 * PI)  # sphere_pdf.value, src/acceleration/pdf.h:22-24


def cosine_direction_local(u1, u2):
    """random_cosine_direction (src/core/vec3.h:149-159) in the z-up frame."""
    phi = 2.0 * PI * u1
    x = torch.cos(phi) * torch.sqrt(u2)
    y = torch.sin(phi) * torch.sqrt(u2)
    z = torch.sqrt(1.0 - u2)
    return torch.stack([x, y, z], dim=-1)


def cosine_direction_world(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` (pdf.h:41-43)."""
    u, v, w = onb_from_w(normal)
    return onb_transform(u, v, w, cosine_direction_local(u1, u2))


def cosine_pdf_value(direction, w_axis):
    """cosine_pdf.value (src/acceleration/pdf.h:36-39)."""
    cos_t = vm.dot(vm.unit_vector(direction), w_axis)
    return torch.clamp_min(cos_t / PI, 0.0)


def uniform_sphere_direction(u1, u2):
    """Uniform direction on the unit sphere (random_unit_vector)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def unit_disk_point(u1, u2):
    """Uniform point in the unit disk (random_in_unit_disk). Returns [..., 2]."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def triangle_barycentric(u1, u2):
    """Uniform barycentric (u, v) with the reference's fold
    (triangle::sample, src/objects/primatives/triangle.h:107-119)."""
    flip = (u1 + u2) > 1.0
    return torch.where(flip, 1.0 - u1, u1), torch.where(flip, 1.0 - u2, u2)
