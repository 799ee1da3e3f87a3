"""The tables of the Plücker clustered hit kernels.

Counterpart of ``bpt_tpu/ops/pallas/plucker.py::pack_plucker_clusters`` and
of the fixed-stride chop boxes it reads (``clusters.py::_cluster_aabbs``),
which feed ``plucker_closest_pallas`` / ``plucker_any_pallas`` (ported as
``ops/kernels/plucker.py``).  Clusters are the fixed-stride chop of the
triangles in BVH leaf order: cluster c holds triangles [32c, 32c + 32).

For a ray (o, d) and a triangle (a, b, c), the three edge products and
the plane numerator are linear in the 10 features

    f = [d, o x d, -o, 1]

so each triangle is four rows of 10 coefficients: w_ab | w_bc | w_ca |
plane.  Vertices are stored relative to their cluster's box centre, and
the kernels translate the ray origin the same way, which keeps the
moments a x b and o x d well conditioned at large coordinates.

The tables, as float32 tensors on the scene's device:
- ``aabb`` [C*6]: each chop cluster's box (lo3, hi3);
- ``blocks`` [C, 128, 10]: rows 0-31 w_ab, 32-63 w_bc, 64-95 w_ca, 96-127
  plane of the cluster's 32 triangles; the rows of unused slots are zero
  (denominator 0: they never pass).  The plain versions read these two;
- ``table`` [C*6 + G*6]: ``aabb``, then the boxes of G groups of 16
  consecutive chop clusters, each the min / max of its members' boxes;
- ``packed`` [C, 22, 32]: the coefficients of ``blocks`` that are not
  zero by construction (each edge row's first 6, the plane row's last 4),
  slot-minor, so that thread s of a warp reads slot s's with coalesced
  loads.  The kernels read these two (csrc/plucker.cu).

``bpt_tpu`` pads the feature dimension to 128 for the TPU's matrix unit;
the port keeps the 10 features it uses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bpt_tpu_torch.ops.clusters import CLUSTER_TRIS, tri_bounds
from bpt_tpu_torch.scene.types import SceneTensors, per_scene

NFEAT = 10
NCOEF = 22  # a triangle's coefficients not zero by construction
GROUP = 16  # chop clusters a group: the closest hit's second level


class PluckerTables(NamedTuple):
    aabb: torch.Tensor  # [C*6] f32, the first C*6 of ``table``
    blocks: torch.Tensor  # [C, 128, 10] f32
    n_clusters: int  # C
    table: torch.Tensor  # [C*6 + G*6] f32: the chop boxes, then the group boxes
    packed: torch.Tensor  # [C, 22, 32] f32: each slot's nonzero coefficients
    n_groups: int  # G


def _chop(x: torch.Tensor, C: int, fill: float) -> torch.Tensor:
    """x [T, k] padded with ``fill`` to C*32 rows, as [C, 32, k]."""
    pad = torch.full((C * CLUSTER_TRIS - x.shape[0], x.shape[1]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad]).reshape(C, CLUSTER_TRIS, x.shape[1])


def chop_aabbs(scene: SceneTensors, C: int) -> torch.Tensor:
    """[C*6] f32: the box (lo3 | hi3) of each chop cluster
    (clusters.py:153-168)."""
    lo, hi = tri_bounds(scene)
    return torch.cat([_chop(lo, C, torch.inf).amin(dim=1),
                      _chop(hi, C, -torch.inf).amax(dim=1)], dim=1).reshape(-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(1)
    bx, by, bz = b.unbind(1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=1)


def pack_plucker_clusters(scene: SceneTensors) -> PluckerTables:
    """The Plücker kernels' tables (plucker.py:53-109, without the padding
    of the features to 128)."""
    T = scene.num_tris
    C = -(-T // CLUSTER_TRIS)
    f32 = torch.float32
    aabb = chop_aabbs(scene, C)
    box = aabb.reshape(C, 6)
    # an all-padding cluster has infinite bounds (plucker.py:74-77)
    ctr = torch.where(torch.isfinite(box[:, :3]) & torch.isfinite(box[:, 3:]),
                      (box[:, :3] + box[:, 3:]) * 0.5, 0.0)
    v0 = scene.v0.to(f32) - ctr.repeat_interleave(CLUSTER_TRIS, dim=0)[:T]
    e1, e2 = scene.e1.to(f32), scene.e2.to(f32)
    a, b, c = v0, v0 + e1, v0 + e2
    n = _cross(e1, e2)
    z3 = torch.zeros((T, 3), dtype=f32, device=scene.device)
    z1 = z3[:, :1]
    n_v0 = n[:, 0:1] * v0[:, 0:1] + n[:, 1:2] * v0[:, 1:2] + n[:, 2:3] * v0[:, 2:3]
    rows = [torch.cat([_cross(a, b), b - a, z3, z1], dim=1),
            torch.cat([_cross(b, c), c - b, z3, z1], dim=1),
            torch.cat([_cross(c, a), a - c, z3, z1], dim=1),
            torch.cat([z3, z3, n, n_v0], dim=1)]
    blocks = torch.cat([_chop(r, C, 0.0) for r in rows], dim=1).contiguous()
    G = -(-C // GROUP)
    pad = torch.tensor([torch.inf] * 3 + [-torch.inf] * 3, device=scene.device)
    groups = torch.cat([box, pad.expand(G * GROUP - C, 6)]).reshape(G, GROUP, 6)
    table = torch.cat([aabb, torch.cat([groups[:, :, :3].amin(dim=1),
                                        groups[:, :, 3:].amax(dim=1)], dim=1).reshape(-1)])
    return PluckerTables(table[:C * 6], blocks, C, table, pack_nonzero(blocks), G)


def pack_nonzero(blocks: torch.Tensor) -> torch.Tensor:
    """[C, NCOEF, 32]: the coefficients of ``blocks`` [C, 128, 10] that are not
    zero by construction, slot-minor: rows 0-17 the three edge rows' first
    6 (w_ab, w_bc, w_ca), rows 18-21 the plane row's last 4."""
    C = blocks.shape[0]
    edge = blocks[:, :3 * CLUSTER_TRIS, :6].reshape(C, 3, CLUSTER_TRIS, 6)
    edge = edge.permute(0, 1, 3, 2).reshape(C, 18, CLUSTER_TRIS)
    plane = blocks[:, 3 * CLUSTER_TRIS:, 6:].permute(0, 2, 1)
    return torch.cat([edge, plane], dim=1).contiguous()


plucker_tables = per_scene(pack_plucker_clusters)
