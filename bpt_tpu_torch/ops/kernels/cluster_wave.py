"""Clustered closest and any hit over per-lane intervals: wrappers and
plain versions.

Counterpart of ``bpt_tpu/ops/pallas/cluster_wave.py::
clustered_closest_pallas`` and ``clustered_any_pallas``, which
``bpt_tpu``'s dispatch (``ops/soa.py:505-516, 599-633``) runs for a hit call
of a large scene over any interval but the production one, and for every
hit call with ``BPT_TPU_NO_FTB`` set.  Here ``ops.soa.closest_hit`` /
``any_hit`` launch ``clustered_closest`` / ``clustered_any``
(``csrc/cluster_wave.cu``) in the same cases on the card, the lanes sorted
by ``morton_octant_key`` first.

What a lane computes, over the tables of ``ops/clusters.py``: the
superclusters in index order, each slab-tested with the bound
``min(t_best, tmax)`` (``tmax`` for the any hit) and the entry clamped to
T_MIN; on an entry, each member cluster slab-tested the same way; on an
entry, the cluster's triangles in slot order by Möller–Trumbore, accepted
on ``t >= T_MIN``, ``tmin <= t <= tmax`` and (closest) ``t < t_best``.  The
triangle id is the cluster's first triangle plus the slot.  The any hit
ends the lane at its first hit.  A lane with tmax <= 0 is dead: it misses
and tests nothing.

Where the port differs from the Pallas kernels, which run 128-lane rows:
- A lane culls a box on its own slab test, where the TPU tests a cluster
  for every lane of the tile when any lane enters it.  A NaN slab term (an
  origin on a box plane, a zero direction component) leaves its axis
  unconstrained, the rule of ``ops/soa.py::_bvh_walk``; on the TPU the NaN
  fails the lane's own test and the lane rides along with its tile.
- Slots are tested in ascending order with a strict ``<``, so of equal t
  the lowest triangle id wins; the Pallas roll shows lane l the slots in
  the order (l + s) mod 32.

On the card both hits run warp-wide (``csrc/cluster_hit.cuh``): a first
kernel compacts the live lanes, then the warps of a persistent grid
slab-test the boxes in step and test an entered cluster's slots for one
entering ray at a time, one slot a thread; ``Lanes.accept`` is the plain
form of that take (the closest hit's scan in slot order, the any hit's
first valid slot).

Dispatch is by device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.  The wrappers count their launches in
``<wrapper>.launches``, the plain versions their calls in
``<plain>.calls``.  Both return counters int64[4] = (slab tests, boxes
entered, triangle tests, accepted tests), equal between kernel and plain
version; they feed the kernels' bound, not ``ops.soa.HitSoA``.
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops import soa
from bpt_tpu_torch.ops.clusters import cluster_tables
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels.pt_kernel import _checked, _device_of
from bpt_tpu_torch.scene.types import SceneTensors

# ---------------------------------------------------------------- sorting


def _spread8(x):
    """Spread the low 8 bits of x three apart (3-D Morton bit twiddling,
    8 bits an axis -> a 24-bit code)."""
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_octant_key(lo, hi, ox, oy, oz, dx, dy, dz):
    """int32 sort key (cluster_wave.py:419-443): the 24-bit Morton code of
    the ray origin quantized over the box [lo, hi] ([3] each, the scene's
    root box), with the direction octant in the low 3 bits."""
    i32 = torch.int32
    ext = torch.clamp_min(hi - lo, 1e-12)

    def q(p, a):
        return (torch.clamp((p - lo[a]) / ext[a], 0.0, 1.0) * 255.0).to(i32)

    m = _spread8(q(ox, 0)) | (_spread8(q(oy, 1)) << 1) | (_spread8(q(oz, 2)) << 2)
    octant = ((dx > 0).to(i32) | ((dy > 0).to(i32) << 1) | ((dz > 0).to(i32) << 2))
    return (m << 3) | octant


# ------------------------------------------------------ plain traversal


class Lanes:
    """The lanes of a plain clustered traversal and their state: the box
    tests, the acceptance of a cluster's candidates in order, and the
    counters, shared by the rolled and the Plücker plain versions."""

    def __init__(self, o: Vec3, d: Vec3, tmin, tmax, any_hit: bool):
        self.any_hit = any_hit
        self.org = torch.stack(list(o), dim=1)
        self.dirs = torch.stack(list(d), dim=1)
        self.inv = 1.0 / self.dirs
        self.tmin, self.tmax = tmin, tmax
        B, kw = tmax.shape[0], dict(dtype=tmax.dtype, device=tmax.device)
        self.t = torch.full((B,), torch.inf, **kw)
        self.tri = torch.full((B,), -1, dtype=torch.int64, device=tmax.device)
        self.u = torch.zeros(B, **kw)
        self.v = torch.zeros(B, **kw)
        self.open = tmax > 0.0  # live and, for the any hit, without a hit yet
        self.counts = torch.zeros(4, dtype=torch.int64, device=tmax.device)

    def live(self) -> torch.Tensor:
        """Ids of the lanes still traversing."""
        return torch.nonzero(self.open).flatten()

    def entering(self, box, L) -> torch.Tensor:
        """The lanes of L whose slab test of box (lo3 | hi3) [6] passes:
        the entry clamped to T_MIN, the exit to min(t_best, tmax) (tmax for
        the any hit); NaN slab terms leave the axis unconstrained."""
        t0 = (box[:3] - self.org[L]) * self.inv[L]
        t1 = (box[3:] - self.org[L]) * self.inv[L]
        nan = torch.isnan(t0) | torch.isnan(t1)
        lo = torch.where(nan, -torch.inf, torch.minimum(t0, t1))
        hi = torch.where(nan, torch.inf, torch.maximum(t0, t1))
        bound = self.tmax[L] if self.any_hit else torch.minimum(self.t[L], self.tmax[L])
        ok = torch.minimum(hi.amin(dim=1), bound) > torch.clamp_min(lo.amax(dim=1), T_MIN)
        self.counts[0] += L.numel()
        self.counts[1] += ok.sum()
        return L[ok]

    def accept(self, L, valid, t, u, v, ids) -> None:
        """Takes the candidates [n, |L|] of one cluster in order (``valid``:
        the test without ``t < t_best``; ``ids`` [n] their triangles): the
        closest hit keeps the first of the smallest t below t_best and
        counts each strict improvement in order; the any hit takes the
        first valid candidate and ends its lane there."""
        n = ids.numel()
        if self.any_hit:
            found = valid.any(dim=0)
            first = valid.to(torch.int8).argmax(dim=0)
            self.counts[2] += torch.where(found, first + 1, n).sum()
            self.counts[3] += found.sum()
            self.tri[L[found]] = ids[first[found]]
            self.open[L[found]] = False
            return
        tm = torch.where(valid, t, torch.inf)
        prev = torch.cat([self.t[L][None], tm[:-1]]).cummin(dim=0).values
        self.counts[2] += n * L.numel()
        self.counts[3] += (tm < prev).sum()
        k = tm.argmin(dim=0)  # the first of equal minima
        t_new = tm.gather(0, k[None])[0]
        better = t_new < self.t[L]
        Lb, kb = L[better], k[better]
        self.t[Lb] = t_new[better]
        self.tri[Lb] = ids[kb]
        self.u[Lb] = u[:, better].gather(0, kb[None])[0]
        self.v[Lb] = v[:, better].gather(0, kb[None])[0]

    def rays(self, L) -> tuple[Vec3, Vec3]:
        return Vec3(*self.org[L].T), Vec3(*self.dirs[L].T)


def _rolled(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax, any_hit: bool) -> Lanes:
    """The rolled kernels' traversal in torch, one box at a time over the
    lanes that reach it."""
    tab = cluster_tables(scene)
    S, C = tab.n_super, tab.n_clusters
    host = tab.table.cpu()
    spans = host[S * 6:S * 8].long().reshape(S, 2).tolist()
    first_tri = host[S * 8:].reshape(C, 7)[:, 6].long().tolist() + [scene.num_tris]
    sup = tab.table[:S * 6].reshape(S, 6)
    rec = tab.table[S * 8:].reshape(C, 7)
    st = Lanes(o, d, tmin, tmax, any_hit)
    for s in range(S):
        L = st.live()
        if not L.numel():
            break
        Ls = st.entering(sup[s], L)
        first, n_m = spans[s]
        for c in range(first, first + n_m):
            if any_hit:
                Ls = Ls[st.open[Ls]]
            if not Ls.numel():
                break
            Lc = st.entering(rec[c, :6], Ls)
            if not Lc.numel():
                continue
            blk = tab.blocks[c, :first_tri[c + 1] - first_tri[c]]
            ro, rd = st.rays(Lc)
            det, t, u, v = soa._mt_all(blk[:, 0:3], blk[:, 3:6], blk[:, 6:9], ro, rd)
            valid = (soa._mt_valid(det, t, u, v, tmin[Lc][None], tmax[Lc][None])
                     & (t >= T_MIN))
            ids = torch.arange(first_tri[c], first_tri[c + 1], device=tmax.device)
            st.accept(Lc, valid, t, u, v, ids)
    return st


# ----------------------------------------------------------- closest hit


def clustered_closest_plain(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Plain version of ``clustered_closest``."""
    clustered_closest_plain.calls += 1
    st = _rolled(scene, o, d, tmin, tmax, any_hit=False)
    return st.t, st.tri.to(torch.int32), st.u, st.v, st.counts


clustered_closest_plain.calls = 0


def cluster_reject_reason(scene: SceneTensors) -> str:
    """Why the clustered kernels (this module's and ``plucker.py``'s)
    cannot take ``scene`` ('' if they can): they take float32, as
    ``bpt_tpu``'s clustered route does (``_wave_cluster_ok``)."""
    if scene.dtype != torch.float32:
        return (f"dtype {scene.dtype} != float32 (the clustered kernels take float32; "
                "a float64 hit of a scene with a BVH takes closest_bvh / any_bvh, and "
                "render() takes float64 through the stratum loop)")
    return ""


def _lanes(what, scene, o: Vec3, d: Vec3, tmin, tmax):
    """Checks what a launch takes: (device, B, [ox, oy, oz, dx, dy, dz,
    tmin, tmax] as contiguous f32 [B] tensors on the scene's device)."""
    dev = _device_of(tmax)
    reason = cluster_reject_reason(scene)
    if reason:
        raise ValueError(f"{what} cannot take this scene: {reason}")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device} but lanes on {dev}")
    B = int(tmax.shape[0]) if tmax.dim() == 1 else -1
    return dev, B, [_checked(x, (B,), dev, f"{what} lane input") for x in (*o, *d, tmin, tmax)]


def launch(what: str, symbol: str, tables, scene: SceneTensors, o: Vec3, d: Vec3,
           tmin, tmax, any_hit: bool):
    """One launch of a clustered hit kernel, ``bpt_clustered_hit`` or
    ``bpt_plucker_hit`` (``csrc/cluster_hit.cuh``'s frame), over
    ``tables(scene)`` = (superclusters or chop groups, clusters, table,
    blocks).  Returns (t, tri, u, v, counters), or (hit, counters) for the
    any hit."""
    dev, B, ins = _lanes(what, scene, o, d, tmin, tmax)
    n_super, n_clusters, table, blocks = tables(scene)
    if any_hit:
        outs = [torch.empty(B, dtype=torch.bool, device=dev)]
        ptrs = [None] * 4 + [outs[0].data_ptr()]
    else:
        kw = dict(dtype=torch.float32, device=dev)
        outs = [torch.empty(B, **kw), torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, **kw), torch.empty(B, **kw)]
        ptrs = [x.data_ptr() for x in outs] + [None]
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    # the compacted lanes: two counters, then 32 slots a warp
    sched = torch.empty(2 + 32 * -(-B // 32), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = getattr(build.load_library(), symbol)(
            int(any_hit), B, n_super, n_clusters, scene.num_tris, table.data_ptr(),
            blocks.data_ptr(), *(x.data_ptr() for x in ins), *ptrs, counters.data_ptr(),
            sched.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, what)
    return (*outs, counters)


def _rolled_tables(scene: SceneTensors):
    tab = cluster_tables(scene)
    return tab.n_super, tab.n_clusters, tab.table, tab.blocks


def clustered_closest(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Closest hit of each ray within its own [tmin, tmax] ([B] f32 each;
    tmax <= 0 marks a dead lane) over the rolled cluster tables.  Returns
    (t [B] f32, inf on a miss; tri [B] int32, -1 on a miss; u, v [B] f32;
    counters int64[4])."""
    if _device_of(tmax).type == "cpu":
        return clustered_closest_plain(scene, o, d, tmin, tmax)
    out = launch("clustered_closest", "bpt_clustered_hit", _rolled_tables, scene, o, d,
                 tmin, tmax, any_hit=False)
    clustered_closest.launches += 1
    return out


clustered_closest.launches = 0


# --------------------------------------------------------------- any hit


def clustered_any_plain(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Plain version of ``clustered_any``."""
    clustered_any_plain.calls += 1
    st = _rolled(scene, o, d, tmin, tmax, any_hit=True)
    return st.tri >= 0, st.counts


clustered_any_plain.calls = 0


def clustered_any(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Whether each ray hits a triangle within its own [tmin, tmax] ([B]
    f32 each; tmax <= 0 marks a dead lane) over the rolled cluster tables,
    the lane ending at its first hit.  Returns (hit [B] bool, counters
    int64[4])."""
    if _device_of(tmax).type == "cpu":
        return clustered_any_plain(scene, o, d, tmin, tmax)
    out = launch("clustered_any", "bpt_clustered_hit", _rolled_tables, scene, o, d, tmin,
                 tmax, any_hit=True)
    clustered_any.launches += 1
    return out


clustered_any.launches = 0
