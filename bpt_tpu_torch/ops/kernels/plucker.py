"""Plücker clustered closest and any hit: wrappers and plain versions.

Counterpart of ``bpt_tpu/ops/pallas/plucker.py::plucker_closest_pallas``
and ``plucker_any_pallas``, which ``bpt_tpu``'s dispatch takes for every
hit call of a large scene with ``BPT_TPU_WAVE_IMPL=plucker``
(``ops/soa.py:410-427``).  Here ``ops.soa.closest_hit`` / ``any_hit``
launch ``plucker_closest`` / ``plucker_any`` (``csrc/plucker.cu``) in that
case on the card.

What a lane computes, over the tables of ``ops/plucker.py``: the chop
clusters in index order, each slab-tested with the bound ``min(t_best,
tmax)`` (``tmax`` for the any hit) and the entry clamped to T_MIN; on an
entry, the origin translated by the box centre ``(lo + hi) * 0.5``, the
features ``f = [d, (o-c) x d, -(o-c), 1]``, and for each triangle in row
order the four dot products ``w_ab``, ``w_bc``, ``w_ca``, ``pn``, each summed
over the 10 features in order.  With ``denom = w_ab + w_bc + w_ca`` a
triangle passes on ``|denom| >= MT_EPSILON``, the signs of ``w_ca``,
``w_ab``, ``w_bc`` and ``w_ab + w_bc`` agreeing with ``denom``'s, and
``t = pn / denom`` in [tmin, tmax] (no T_MIN test) and below t_best (inf
at first: the any hit takes no t that overflows); u =
w_ca / denom, v = w_ab / denom, the triangle id 32 c + row, the lowest row
winning a tie.  The any hit ends the lane at its first hit.  A lane with
tmax <= 0 is dead.

The Pallas kernels run the products as one f32 matrix product a cluster
at the highest precision; the kernel and the plain version here sum the
same 10 products in the same order, so that on the card they agree to the
bit.  Culling is per lane, NaN slab terms leave their axis unconstrained
(``ops/kernels/cluster_wave.py``'s notes): with tmin below T_MIN a lane
finds hits in [tmin, T_MIN) only in the clusters its own slab test enters.

Dispatch is by device, with launch and call counts, as in
``ops/kernels/cluster_wave.py``; counters int64[4] = (slab tests, boxes
entered, triangle tests, accepted tests).
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops.intersect import MT_EPSILON
from bpt_tpu_torch.ops.kernels.cluster_wave import Lanes, launch
from bpt_tpu_torch.ops.kernels.pt_kernel import _device_of
from bpt_tpu_torch.ops.plucker import CLUSTER_TRIS, NFEAT, plucker_tables
from bpt_tpu_torch.scene.types import SceneTensors


def _agrees(x, pos):
    """sign(x) agrees with sign(denom) (plucker.py:160-163)."""
    return ((x >= 0.0) & pos) | ((x <= 0.0) & ~pos)


def _plucker(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax, any_hit: bool) -> Lanes:
    """The Plücker kernels' traversal in torch, one chop cluster at a time
    over the lanes that reach it."""
    tab = plucker_tables(scene)
    T = scene.num_tris
    box = tab.aabb.reshape(-1, 6)
    st = Lanes(o, d, tmin, tmax, any_hit)
    for c in range(tab.n_clusters):
        L = st.live()
        if not L.numel():
            break
        L = st.entering(box[c], L)
        if not L.numel():
            continue
        ctr = (box[c, :3] + box[c, 3:]) * 0.5
        p = st.org[L] - ctr
        dx, dy, dz = st.dirs[L].T
        px, py, pz = p.T
        f = [dx, dy, dz, py * dz - pz * dy, pz * dx - px * dz, px * dy - py * dx,
             -px, -py, -pz, torch.ones_like(px)]
        n = min(CLUSTER_TRIS, T - c * CLUSTER_TRIS)
        rows = torch.cat([tab.blocks[c, g * CLUSTER_TRIS:g * CLUSTER_TRIS + n]
                          for g in range(4)])  # [4n, 10]
        w = rows[:, 0:1] * f[0][None]
        for k in range(1, NFEAT):  # the 10 products in feature order
            w = w + rows[:, k:k + 1] * f[k][None]
        w_ab, w_bc, w_ca, pn = w.split(n)
        denom = w_ab + w_bc + w_ca
        pos = denom > 0.0
        rd = 1.0 / denom
        t = pn * rd
        valid = ((torch.abs(denom) >= MT_EPSILON) & _agrees(w_ca, pos) & _agrees(w_ab, pos)
                 & _agrees(w_bc, pos) & _agrees(w_ab + w_bc, pos)
                 & (t >= tmin[L][None]) & (t <= tmax[L][None]) & (t < torch.inf))
        ids = torch.arange(c * CLUSTER_TRIS, c * CLUSTER_TRIS + n, device=tmax.device)
        st.accept(L, valid, t, w_ca * rd, w_ab * rd, ids)
    return st


# ----------------------------------------------------------- closest hit


def plucker_closest_plain(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Plain version of ``plucker_closest``."""
    plucker_closest_plain.calls += 1
    st = _plucker(scene, o, d, tmin, tmax, any_hit=False)
    return st.t, st.tri.to(torch.int32), st.u, st.v, st.counts


plucker_closest_plain.calls = 0


def _group_tables(scene: SceneTensors):
    tab = plucker_tables(scene)
    return tab.n_groups, tab.n_clusters, tab.table, tab.packed


def plucker_closest(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Closest hit of each ray within its own [tmin, tmax] ([B] f32 each;
    tmax <= 0 marks a dead lane) by Plücker products over the chop
    clusters.  Returns (t [B] f32, inf on a miss; tri [B] int32, -1 on a
    miss; u, v [B] f32; counters int64[4])."""
    if _device_of(tmax).type == "cpu":
        return plucker_closest_plain(scene, o, d, tmin, tmax)
    out = launch("plucker_closest", "bpt_plucker_hit", _group_tables, scene, o, d, tmin,
                 tmax, any_hit=False)
    plucker_closest.launches += 1
    return out


plucker_closest.launches = 0


# --------------------------------------------------------------- any hit


def plucker_any_plain(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Plain version of ``plucker_any``."""
    plucker_any_plain.calls += 1
    st = _plucker(scene, o, d, tmin, tmax, any_hit=True)
    return st.tri >= 0, st.counts


plucker_any_plain.calls = 0


def plucker_any(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Whether each ray hits a triangle within its own [tmin, tmax] ([B]
    f32 each; tmax <= 0 marks a dead lane) by Plücker products over the
    chop clusters, the lane ending at its first hit.  Returns (hit [B]
    bool, counters int64[4])."""
    if _device_of(tmax).type == "cpu":
        return plucker_any_plain(scene, o, d, tmin, tmax)
    out = launch("plucker_any", "bpt_plucker_hit", _group_tables, scene, o, d, tmin, tmax,
                 any_hit=True)
    plucker_any.launches += 1
    return out


plucker_any.launches = 0
