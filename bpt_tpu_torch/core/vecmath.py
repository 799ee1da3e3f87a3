"""Batched 3-vector algebra on ``[..., 3]`` tensors.

Counterpart of ``bpt_tpu.core.vecmath`` (reference: src/core/vec3.h:1-161);
the hot path uses the component-SoA form in :mod:`bpt_tpu_torch.core.vec3`.
"""

from __future__ import annotations

import torch

PI = 3.1415926535897932385  # reference: src/main.h:20


def dot(u, v):
    """Batched dot product over the trailing axis (src/core/vec3.h:97-101)."""
    return torch.sum(u * v, dim=-1)


def cross(u, v):
    """Batched cross product (src/core/vec3.h:103-107)."""
    return torch.stack(
        [
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
        ],
        dim=-1,
    )


def length_squared(v):
    return torch.sum(v * v, dim=-1)


def length(v):
    return torch.sqrt(length_squared(v))


def unit_vector(v):
    """v / |v| (src/core/vec3.h:109-111). No epsilon — faithful to reference."""
    return v / length(v)[..., None]


def normalize_safe(v, eps=1e-20):
    """Division-safe normalize for lanes that may hold dead rays."""
    n2 = length_squared(v)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp_min(n2, eps)), 0.0)
    return v * inv[..., None]


def reflect(v, n):
    """Mirror reflection v - 2(v.n)n (src/core/vec3.h:138-140)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of a *unit* vector (src/core/vec3.h:142-147)."""
    eta = torch.as_tensor(etai_over_etat, dtype=uv.dtype, device=uv.device)[..., None]
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)[..., None]
    r_out_perp = eta * (uv + cos_theta * n)
    r_out_parallel = (
        -torch.sqrt(torch.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel


def schlick_reflectance(cosine, refraction_index):
    """Schlick's approximation (src/materials/material.h:125-130)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5
