"""The cluster tables of the rolled clustered hit kernels.

Counterpart of the packing in ``bpt_tpu/ops/pallas/clusters.py``
(``_splits_of``, ``_combined_table``, ``_pack_blocks``), which feeds
``bpt_tpu``'s non-FTB clustered closest and any hit
(``cluster_wave.py::clustered_closest_pallas`` / ``clustered_any_pallas``,
ported as ``ops/kernels/cluster_wave.py``).  Triangles stay in BVH leaf
order; clusters are maximal BVH subtrees of <= 32 triangles and
superclusters maximal subtrees of <= 512 (the scene's ``cluster_splits`` /
``super_splits``, scene/builder.py), or a fixed-stride chop where the scene
has none.

Two tables, as float32 tensors on the scene's device:
- the combined table, ``bpt_tpu``'s exact layout: [S*6 super boxes (lo3,
  hi3) | S*2 spans (first cluster, member count) | C*7 cluster records
  (lo3, hi3, first triangle)];
- the triangle blocks [C, 32, 9]: (v0, e1, e2) of each cluster's triangles
  in order, the unused slots zero (det = 0: they never pass).

The TPU layout does not carry over: ``bpt_tpu``'s blocks hold 13 fields
(normal and material too) transposed to [16, 128], each slot replicated
on four lanes and three pad rows added, for ``pltpu.roll`` over 128-lane
VMEM tiles.  The port's kernels read a cluster's triangles in slot order
from device memory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bpt_tpu_torch.scene.types import SceneTensors, per_scene

CLUSTER_TRIS = 32  # triangles a cluster (clusters.py:43)
SUPER = 16  # clusters a supercluster, 512 triangles (clusters.py:45)
# cluster cap of bpt_tpu's split choice (clusters.py:53): past it the
# builder leaves the splits empty and the tables take the chop
MAX_CLUSTERS = 16384


class ClusterTables(NamedTuple):
    """The rolled kernels' tables, on the scene's device."""

    table: torch.Tensor  # [S*6 + S*2 + C*7] f32, the combined table
    blocks: torch.Tensor  # [C, 32, 9] f32: v0, e1, e2 of each slot
    n_super: int  # S
    n_clusters: int  # C


def splits_of(scene: SceneTensors) -> tuple[tuple, tuple]:
    """(cluster splits, super splits): the scene's subtree-aligned
    boundaries, or the fixed-stride chop (32 and 512 triangles) where it
    has none (clusters.py:171-186)."""
    T = scene.num_tris
    cs, ss = tuple(scene.cluster_splits), tuple(scene.super_splits)
    if len(cs) >= 2 and len(ss) >= 2 and cs[-1] == T and ss[-1] == T:
        return cs, ss
    C = -(-T // CLUSTER_TRIS)
    S = -(-C // SUPER)
    cs = tuple(min(k * CLUSTER_TRIS, T) for k in range(C + 1))
    ss = tuple(min(k * SUPER * CLUSTER_TRIS, T) for k in range(S + 1))
    return cs, ss


def slot_index(cs, T: int) -> np.ndarray:
    """[C, 32] int64: the triangle of each cluster slot, T in the slots a
    cluster does not fill (a sentinel row)."""
    C = len(cs) - 1
    idx = np.full((C, CLUSTER_TRIS), T, np.int64)
    for k in range(C):
        idx[k, :cs[k + 1] - cs[k]] = np.arange(cs[k], cs[k + 1])
    return idx


def tri_bounds(scene: SceneTensors) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) [T, 3] f32 of each triangle's vertices v0, v0 + e1, v0 + e2
    (the sums in the scene's dtype, then the cast, as clusters.py:197-199)."""
    f32 = torch.float32
    p = (scene.v0.to(f32), (scene.v0 + scene.e1).to(f32), (scene.v0 + scene.e2).to(f32))
    return (torch.minimum(p[0], torch.minimum(p[1], p[2])),
            torch.maximum(p[0], torch.maximum(p[1], p[2])))


def _padded(x: torch.Tensor, fill: float) -> torch.Tensor:
    """x [n, k] with one more row of ``fill`` (the sentinel)."""
    return torch.cat([x, torch.full((1, x.shape[1]), fill, dtype=x.dtype, device=x.device)])


def combined_table(scene: SceneTensors, cs, ss) -> torch.Tensor:
    """The combined table (clusters.py:188-234): super boxes, per-super
    member spans and cluster records (box, first triangle), float32."""
    T, dev = scene.num_tris, scene.device
    C, S = len(cs) - 1, len(ss) - 1
    lo, hi = tri_bounds(scene)
    idx = torch.from_numpy(slot_index(cs, T)).to(dev)
    cl_lo = _padded(lo, torch.inf)[idx].amin(dim=1)  # [C, 3]
    cl_hi = _padded(hi, -torch.inf)[idx].amax(dim=1)
    base = torch.tensor(cs[:-1], dtype=torch.float32, device=dev)[:, None]
    start_of = {v: k for k, v in enumerate(cs)}
    sc_first = np.asarray([start_of[v] for v in ss], np.int64)
    n_mem = np.diff(sc_first)
    m_map = np.full((S, int(n_mem.max()) if S else 1), C, np.int64)
    for k in range(S):
        m_map[k, :n_mem[k]] = np.arange(sc_first[k], sc_first[k + 1])
    m_map = torch.from_numpy(m_map).to(dev)
    su = torch.cat([_padded(cl_lo, torch.inf)[m_map].amin(dim=1),
                    _padded(cl_hi, -torch.inf)[m_map].amax(dim=1)], dim=1)
    spans = torch.from_numpy(np.stack([sc_first[:-1], n_mem], axis=1).astype(np.float32))
    return torch.cat([su.reshape(-1), spans.to(dev).reshape(-1),
                      torch.cat([cl_lo, cl_hi, base], dim=1).reshape(-1)]).contiguous()


def pack_blocks(scene: SceneTensors, cs) -> torch.Tensor:
    """[C, 32, 9] f32: (v0, e1, e2) of each cluster's triangles in slot
    order, zero in the unused slots (clusters.py:255-277, un-replicated)."""
    tri = torch.cat([scene.v0, scene.e1, scene.e2], dim=1).to(torch.float32)
    idx = torch.from_numpy(slot_index(cs, scene.num_tris)).to(scene.device)
    return _padded(tri, 0.0)[idx].contiguous()


@per_scene
def cluster_tables(scene: SceneTensors) -> ClusterTables:
    """The rolled kernels' tables of ``scene``, packed once and kept while
    the scene lives."""
    cs, ss = splits_of(scene)
    return ClusterTables(combined_table(scene, cs, ss), pack_blocks(scene, cs),
                         len(ss) - 1, len(cs) - 1)
