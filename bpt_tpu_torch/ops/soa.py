"""SoA brute-force intersection over component tensors.

Counterpart of the brute-force half of ``bpt_tpu.ops.soa``: closest and
any hit of every ray against every triangle as one [T, B] broadcast, with
the reference's epsilon and comparison order (triangle.h:41-74) and
first-hit-wins on exact t ties.  BVH traversal is not ported (ROADMAP §1
item 9); ``closest_hit``/``any_hit`` sweep all triangles for every scene,
which gives the same hits as the BVH.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops.intersect import MT_EPSILON
from bpt_tpu_torch.scene.types import SceneTensors


class HitSoA(NamedTuple):
    hit: torch.Tensor  # [B] bool
    t: torch.Tensor  # [B] (inf when miss)
    tri: torch.Tensor  # [B] int64
    u: torch.Tensor  # [B]
    v: torch.Tensor  # [B]
    # reference BvhStats counters, summed over the wave (int64 scalars)
    node_visits: torch.Tensor
    aabb_hits: torch.Tensor
    tri_tests: torch.Tensor
    tri_hits: torch.Tensor


def _mt_valid(det, t, u, v, tmin, tmax):
    return (
        (torch.abs(det) >= MT_EPSILON)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin) & (t <= tmax)
    )


def _mt_all(v0a, e1a, e2a, o: Vec3, d: Vec3):
    """Möller–Trumbore of every ray against every triangle as one [T, B]
    broadcast.  Returns (det, t, u, v), each [T, B]."""
    dx, dy, dz = d.x[None], d.y[None], d.z[None]  # [1,B]
    ox, oy, oz = o.x[None], o.y[None], o.z[None]
    e2x, e2y, e2z = e2a[:, 0:1], e2a[:, 1:2], e2a[:, 2:3]  # [T,1]
    e1x, e1y, e1z = e1a[:, 0:1], e1a[:, 1:2], e1a[:, 2:3]
    v0x, v0y, v0z = v0a[:, 0:1], v0a[:, 1:2], v0a[:, 2:3]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / det
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return det, t, u, v


def brute_closest(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax) -> HitSoA:
    """Closest hit over all triangles; argmin over T (first hit wins on
    exact ties).  tmin/tmax: [B]."""
    T = scene.num_tris
    det, t, u, v = _mt_all(scene.v0, scene.e1, scene.e2, o, d)
    valid = _mt_valid(det, t, u, v, tmin[None], tmax[None])
    t_masked = torch.where(valid, t, torch.inf)
    tri = torch.argmin(t_masked, dim=0)  # [B]
    t_best = torch.gather(t_masked, 0, tri[None])[0]
    hit = torch.isfinite(t_best)
    B = o.x.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=o.x.device)
    return HitSoA(
        hit=hit, t=t_best, tri=tri,
        u=torch.gather(u, 0, tri[None])[0],
        v=torch.gather(v, 0, tri[None])[0],
        node_visits=zero, aabb_hits=zero,
        tri_tests=torch.tensor(T * B, dtype=torch.int64, device=o.x.device),
        tri_hits=hit.sum(dtype=torch.int64),
    )


def brute_any(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Any-hit over all triangles: bool [B]."""
    det, t, u, v = _mt_all(scene.v0, scene.e1, scene.e2, o, d)
    return torch.any(_mt_valid(det, t, u, v, tmin[None], tmax[None]), dim=0)


def _bounds(o: Vec3, tmin, tmax, mask):
    B = o.x.shape[0]
    kw = dict(dtype=o.x.dtype, device=o.x.device)
    tmin_b = torch.broadcast_to(torch.as_tensor(tmin, **kw), (B,))
    tmax_b = torch.broadcast_to(torch.as_tensor(tmax, **kw), (B,))
    if mask is not None:
        tmax_b = torch.where(mask, tmax_b, 0.0)
    return tmin_b, tmax_b


def closest_hit(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax,
                mask=None) -> HitSoA:
    """mask: optional [B] bool — lanes with mask=False are culled (tmax
    collapses to 0) and excluded from the stats counters."""
    tmin_b, tmax_b = _bounds(o, tmin, tmax, mask)
    h = brute_closest(scene, o, d, tmin_b, tmax_b)
    if mask is not None:
        h = h._replace(
            tri_tests=mask.sum(dtype=torch.int64) * scene.num_tris,
            tri_hits=(h.hit & mask).sum(dtype=torch.int64),
        )
    return h


def any_hit(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax, mask=None):
    tmin_b, tmax_b = _bounds(o, tmin, tmax, mask)
    return brute_any(scene, o, d, tmin_b, tmax_b)


class HitRecSoA(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    p: Vec3
    normal: Vec3  # flipped against the ray (set_face_normal, hittable.h:20-26)
    front_face: torch.Tensor
    tri: torch.Tensor
    mat: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def complete_hit(scene: SceneTensors, o: Vec3, d: Vec3, h: HitSoA) -> HitRecSoA:
    t_safe = torch.where(h.hit, h.t, 0.0)
    p = Vec3(o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z)
    nrm = v3.gather(scene.normal, h.tri)
    front = v3.dot(d, nrm) < 0.0
    normal = v3.where(front, nrm, -nrm)
    return HitRecSoA(
        hit=h.hit, t=h.t, p=p, normal=normal, front_face=front,
        tri=h.tri, mat=scene.mat_id[h.tri], u=h.u, v=h.v,
    )
