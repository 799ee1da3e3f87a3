"""Component-SoA 3-vectors: x/y/z as separate [B] tensors.

Counterpart of ``bpt_tpu.core.vec3``: the hot-path vector algebra of the
wavefront, with the same operation order so results agree to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # elementwise arithmetic (scalar or Vec3 operands)
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def from_array(a: torch.Tensor) -> Vec3:
    """[..., 3] -> Vec3 of [...] components (boundary conversion)."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3) -> torch.Tensor:
    return torch.stack([v.x, v.y, v.z], dim=-1)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_squared(v: Vec3):
    return dot(v, v)


def length(v: Vec3):
    return torch.sqrt(length_squared(v))


def unit(v: Vec3) -> Vec3:
    inv = 1.0 / length(v)
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def normalize_safe(v: Vec3, eps=1e-20) -> Vec3:
    """Zero vector for |v|^2 <= eps (dead lanes), unit vector otherwise."""
    n2 = length_squared(v)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp_min(n2, eps)), 0.0)
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """mask: [B] bool."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def scale_add(acc: Vec3, mask, term: Vec3) -> Vec3:
    """acc + (mask ? term : 0) — the radiance-accumulate idiom."""
    return Vec3(
        acc.x + torch.where(mask, term.x, 0.0),
        acc.y + torch.where(mask, term.y, 0.0),
        acc.z + torch.where(mask, term.z, 0.0),
    )


def reflect(v: Vec3, n: Vec3) -> Vec3:
    d = dot(v, n)
    return Vec3(v.x - 2.0 * d * n.x, v.y - 2.0 * d * n.y, v.z - 2.0 * d * n.z)


def refract(uv: Vec3, n: Vec3, eta) -> Vec3:
    """Snell refraction of a unit vector (vec3.h:142-147); eta: [B]."""
    cos_t = torch.clamp_max(dot(-uv, n), 1.0)
    perp = Vec3(
        eta * (uv.x + cos_t * n.x),
        eta * (uv.y + cos_t * n.y),
        eta * (uv.z + cos_t * n.z),
    )
    par = -torch.sqrt(torch.abs(1.0 - length_squared(perp)))
    return Vec3(perp.x + par * n.x, perp.y + par * n.y, perp.z + par * n.z)


def gather(table: torch.Tensor, idx: torch.Tensor) -> Vec3:
    """table: [N,3]; idx: [B] int -> Vec3 of [B]."""
    return Vec3(table[idx, 0], table[idx, 1], table[idx, 2])


def onb_from_w(n: Vec3):
    """Reference ONB construction (onb.h:4-14), SoA."""
    w = unit(n)
    pick = torch.abs(w.x) > 0.9
    ax = torch.where(pick, 0.0, 1.0).to(w.x.dtype)
    ay = torch.where(pick, 1.0, 0.0).to(w.x.dtype)
    a = Vec3(ax, ay, torch.zeros_like(ax))
    v = unit(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_transform(u: Vec3, v: Vec3, w: Vec3, lx, ly, lz) -> Vec3:
    return Vec3(
        lx * u.x + ly * v.x + lz * w.x,
        lx * u.y + ly * v.y + lz * w.y,
        lx * u.z + ly * v.z + lz * w.z,
    )
