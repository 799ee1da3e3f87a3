"""The warp-wide closest hits of the clustered kernels (clustered_closest,
plucker_closest) on a CPU: the tables they read and the identities their
design rests on, each held exactly, on numpy-seeded scenes and rays.

- The Plücker closest hit reads each slot's 22 coefficients that are not
  zero by construction from a [C, 22, 32] table: it must equal the
  [C, 128, 10] blocks there, and every coefficient it drops must be +0.0,
  the zero whose products the lane-serial sums add.
- It skips a group of 16 chop clusters whose box no lane of the warp
  enters: every lane that enters a chop box must enter its group's box.
  Its bound counts the slab tests and tables that design needs
  (chip_smoke.py's plucker_closest_needs).
- A warp tests a cluster's slots for one ray at once and takes the
  candidates below t_best in slot order with a strict <: the last one taken
  and the count taken must equal ``Lanes.accept``'s winner (the first of
  the smallest t) and accepted tests, ties and tmin below T_MIN included.
- A CPU tensor takes the plain version and launches nothing."""

import dataclasses

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops import plucker as tpl
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import cluster_wave as tcw
from bpt_tpu_torch.ops.kernels import plucker as tkp
from bpt_tpu_torch.scene import builder, presets
from torch_parity import big_rays, big_scene, mixed_scene

import chip_smoke

B = 257


def _soup(T, seed=3):
    """T random triangles (no light): T chosen for the chop's shape."""
    MS = builder.MaterialSpec
    g = np.random.default_rng(seed)
    b = builder.SceneBuilder()
    for _ in range(T):
        p = g.uniform(-2, 2, 3)
        b.add_triangle(tuple(p), tuple(p + g.normal(0, 0.3, 3)), tuple(p + g.normal(0, 0.3, 3)),
                       MS.lambertian((0.7, 0.7, 0.7)))
    return b.build(device="cpu")


def _scene(which):
    if which == "big":
        return big_scene(builder, device="cpu")
    if which == "mixed":
        return mixed_scene(builder, presets, device="cpu")
    if which == "chop fallback":
        s = big_scene(builder, device="cpu")
        return dataclasses.replace(s, cluster_splits=(), super_splits=())
    if which == "whole clusters":
        return _soup(64 * 32)
    return _soup(17 * 32 - 5)  # "partial last group": 17 chop clusters, the last partial


SCENES = ["big", "mixed", "chop fallback", "whole clusters", "partial last group"]


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("which", SCENES)
def test_packed_table_equals_blocks(which):
    """The [C, 22, 32] table holds the blocks' nonzero coefficients to the
    bit, every coefficient it drops is +0.0, the group boxes are the min /
    max of their members' boxes and the table starts with the chop boxes."""
    scene = _scene(which)
    tab = tpl.pack_plucker_clusters(scene)
    C, G = tab.n_clusters, tab.n_groups
    assert tab.packed.shape == (C, tpl.NCOEF, 32) and tab.packed.is_contiguous()
    assert C == -(-scene.num_tris // 32) and G == -(-C // tpl.GROUP)
    blocks = tab.blocks.reshape(C, 4, 32, tpl.NFEAT)
    for e in range(3):
        assert torch.equal(_bits(tab.packed[:, 6 * e:6 * e + 6]),
                           _bits(blocks[:, e, :, :6].transpose(1, 2)))
        assert not bool(_bits(blocks[:, e, :, 6:]).any())  # +0.0: every bit clear
    assert torch.equal(_bits(tab.packed[:, 18:]), _bits(blocks[:, 3, :, 6:].transpose(1, 2)))
    assert not bool(_bits(blocks[:, 3, :, :6]).any())
    assert torch.equal(tab.table[:C * 6], tab.aabb)
    boxes = tab.aabb.reshape(C, 6)
    groups = tab.table[C * 6:].reshape(G, 6)
    assert tab.table.numel() == 6 * (C + G)
    for g in range(G):
        members = boxes[g * tpl.GROUP:(g + 1) * tpl.GROUP]
        assert torch.equal(groups[g, :3], members[:, :3].amin(dim=0))
        assert torch.equal(groups[g, 3:], members[:, 3:].amax(dim=0))


@pytest.mark.parametrize("planes", [False, True], ids=["random", "on box planes"])
def test_group_box_holds_its_members(planes):
    """With any bound, a lane entering a chop cluster's box enters its
    group's box: so a group no lane enters holds no entered cluster.  With
    ``planes``, each origin lies on a plane of a chop box and that axis'
    direction component is zero (NaN slab terms)."""
    scene = _soup(40 * 32 + 7, seed=8)
    tab = tpl.pack_plucker_clusters(scene)
    boxes = tab.aabb.reshape(-1, 6)
    groups = tab.table[tab.n_clusters * 6:].reshape(-1, 6)
    g = np.random.default_rng(9)
    n = 2048
    o = g.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    if planes:
        k = g.integers(0, tab.n_clusters, n)
        for i in range(n):
            a = i % 3
            o[i, a] = float(boxes[k[i], a + 3 * (i // 3 % 2)])
            d[i, a] = 0.0
    st = tcw.Lanes(Vec3(*torch.from_numpy(o).unbind(1)), Vec3(*torch.from_numpy(d).unbind(1)),
                   torch.full((n,), T_MIN), torch.from_numpy(g.uniform(0.5, 6.0, n).astype(np.float32)),
                   any_hit=False)
    st.t = torch.from_numpy(np.where(g.uniform(size=n) < 0.5, np.inf,
                                     g.uniform(0.1, 6.0, n)).astype(np.float32))
    lanes = torch.arange(n)
    entered = 0
    for c in range(tab.n_clusters):
        inner = set(st.entering(boxes[c], lanes).tolist())
        outer = set(st.entering(groups[c // tpl.GROUP], lanes).tolist())
        assert inner <= outer
        entered += len(inner)
    assert entered > 0


def _warp_take(valid, t, t0):
    """The kernel's take (cluster_hit.cuh::warp_take) of one cluster for each
    lane (column): the candidates are the valid slots with t below the
    lane's t_best t0, scanned in slot order with a strict <.  Returns (taken
    count, last slot taken or -1, its t or t0)."""
    n, L = t.shape
    run, win, taken = t0.clone(), torch.full((L,), -1), torch.zeros(L, dtype=torch.int64)
    cand = valid & (t < t0[None])
    for s in range(n):
        take = cand[s] & (t[s] < run)
        run = torch.where(take, t[s], run)
        win = torch.where(take, s, win)
        taken += take
    return taken, win, run


def _lanes(kind, seed):
    """Lanes of big_rays with per-lane intervals of ``kind``; "production"
    and "finite tmax" start among a triangle soup's triangles (many
    candidates a cluster), "ties" aim at the duplicated sphere."""
    o, d = big_rays(B, seed)
    g = np.random.default_rng(seed + 1)
    if kind in ("production", "finite tmax"):
        o = g.uniform(-2.0, 2.0, (B, 3)).astype(np.float32)
    tmin = np.full(B, T_MIN, np.float32)
    tmax = np.full(B, np.inf, np.float32)
    if kind == "finite tmax":
        tmax = g.uniform(0.5, 4.0, B).astype(np.float32)
        tmax[::7] = np.inf
        tmax[::9] = 0.0
    elif kind == "tmin below T_MIN":
        tmin = np.where(np.arange(B) % 3 == 0, 0.0, g.uniform(-1.0, T_MIN, B)).astype(np.float32)
    if kind == "ties":  # rays through the duplicated sphere's centre region
        c = np.array([0.0, 1.0, 0.0])
        u = g.normal(size=(B, 3))
        o = (c + 3.0 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
        d = (c + g.uniform(-0.5, 0.5, (B, 3)) - o).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return Vec3(*t(o).unbind(1)), Vec3(*t(d).unbind(1)), t(tmin), t(tmax)


@pytest.mark.parametrize("kind", ["production", "finite tmax", "tmin below T_MIN", "ties"])
@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_warp_take_equals_accept(impl, kind, monkeypatch):
    """For every cluster a lane enters in the plain traversal, the warp
    form's last candidate taken and count taken equal what
    ``Lanes.accept`` leaves: its winner (t, triangle, u, v) and its
    accepted tests."""
    scene = {"ties": lambda: chip_smoke.dup_scene("cpu"),
             "tmin below T_MIN": lambda: big_scene(builder, device="cpu")}.get(
        kind, lambda: _soup(40 * 32 + 7, seed=8))()
    o, d, tmin, tmax = _lanes(kind, 41)
    accept = tcw.Lanes.accept
    seen = {"clusters": 0, "taken": 0, "multi": 0, "ties": 0}

    def checked(self, L, valid, t, u, v, ids):
        t0 = self.t[L].clone()
        before = self.counts[3].clone()
        taken, win, run = _warp_take(valid, t, t0)
        accept(self, L, valid, t, u, v, ids)
        took = win >= 0
        assert torch.equal(self.counts[3] - before, taken.sum())
        assert torch.equal(_bits(self.t[L]), _bits(run))
        assert torch.equal(self.tri[L][took], ids[win[took]])
        cols = torch.nonzero(took).flatten()
        assert torch.equal(_bits(self.u[L][took]), _bits(u[win[took], cols]))
        assert torch.equal(_bits(self.v[L][took]), _bits(v[win[took], cols]))
        tm = torch.where(valid, t, torch.inf)
        seen["clusters"] += L.numel()
        seen["taken"] += int(took.sum())
        seen["multi"] += int((taken > 1).sum())
        seen["ties"] += int(((tm == run[None]).sum(dim=0) > 1)[took].sum())

    monkeypatch.setattr(tcw.Lanes, "accept", checked)
    plain = tcw.clustered_closest_plain if impl == "roll" else tkp.plucker_closest_plain
    plain(scene, o, d, tmin, tmax)
    assert seen["taken"] > 0 and seen["clusters"] > seen["taken"]
    if kind == "ties":
        assert seen["ties"] > 0
    if kind != "tmin below T_MIN":
        assert seen["multi"] > 0


@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_cpu_lanes_take_the_plain_version(impl):
    """A CPU tensor takes the plain version, and the wrapper's launch count
    stays at 0."""
    kern, plain = ((tcw.clustered_closest, tcw.clustered_closest_plain) if impl == "roll" else
                   (tkp.plucker_closest, tkp.plucker_closest_plain))
    scene = big_scene(builder, device="cpu")
    o, d, tmin, tmax = _lanes("finite tmax", 5)
    launches, calls = kern.launches, plain.calls
    got = kern(scene, o, d, tmin, tmax)
    assert (kern.launches, plain.calls) == (launches, calls + 1) and launches == 0
    want = plain(scene, o, d, tmin, tmax)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_chip_smoke_reads_the_clustered_kernels_ptxas_lines():
    """chip_smoke.py's kernels line takes the four clustered kernels'
    registers and spill bytes from the build log: the warp-wide closest
    hits (cluster_closest<...>) and the any hits (cluster_any<...>), and an
    earlier build's lane-serial closest and any hits (cluster_hit<...,
    false> and <..., true>) for the A/B tool."""
    def entry(name, regs, spill):
        return [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                f"ptxas info    : Used {regs} registers, used 1 barriers, 380 bytes cmem[0]"]

    log = (entry("_ZN3bpt15cluster_closestINS_8RolledMTEEEvNS_16ClusterHitParamsEPi", 72, 0)
           + entry("_ZN3bpt12cluster_liveINS_8RolledMTEEEvNS_16ClusterHitParamsEPi", 16, 0)
           + entry("_ZN3bpt11cluster_anyINS_8RolledMTEEEvNS_16ClusterHitParamsE", 53, 0)
           + entry("_ZN3bpt15cluster_closestINS_11PluckerChopEEEvNS_16ClusterHitParamsEPi", 80, 8)
           + entry("_ZN3bpt11cluster_anyINS_11PluckerChopEEEvNS_16ClusterHitParamsE", 48, 0))
    got = chip_smoke.cluster_ptxas(log)
    assert {k: (v["registers"], v["spill_bytes"]) for k, v in got.items()} == {
        "clustered_closest": (72, [0, 0]), "clustered_any": (53, [0, 0]),
        "plucker_closest": (80, [8, 8]), "plucker_any": (48, [0, 0])}
    parent = chip_smoke.cluster_ptxas(
        entry("_ZN3bpt11cluster_hitINS_11PluckerChopELb0EEEvNS_16ClusterHitParamsE", 56, 0)
        + entry("_ZN3bpt11cluster_hitINS_11PluckerChopELb1EEEvNS_16ClusterHitParamsE", 48, 0))
    assert {k: v["registers"] for k, v in parent.items()} == {"plucker_closest": 56,
                                                              "plucker_any": 48}


@pytest.mark.parametrize("which", ["big", "mixed", "partial last group"])
def test_plucker_closest_needs_counts_the_group_design(which):
    """chip_smoke.py's plucker_closest_needs, the bound's slab tests and
    table bytes of the grouped Plücker closest hit: each live lane's G group
    boxes plus the members of each group whose box (ops/plucker.py's
    ``table``) it enters before its closest hit, and the bytes of ``table``
    and ``packed``."""
    scene = _scene(which)
    tab = tpl.pack_plucker_clusters(scene)
    C, G = tab.n_clusters, tab.n_groups
    o, d, tmin, tmax = _lanes("finite tmax", 7)
    t, tri, _, _, counts = tkp.plucker_closest_plain(scene, o, d, tmin, tmax)
    slabs, nbytes = chip_smoke.plucker_closest_needs(tab.aabb, o, d, tmax, t, chunk=100)
    st = tcw.Lanes(o, d, tmin, tmax, any_hit=False)
    st.t = t.clone()
    live = torch.nonzero(tmax > 0).flatten()
    want, opened = G * live.numel(), 0
    for g, box in enumerate(tab.table[C * 6:].reshape(G, 6)):
        n = st.entering(box, live).numel()
        want += n * min(tpl.GROUP, C - g * tpl.GROUP)
        opened += n
    assert slabs == want and opened > 0 and bool((tri >= 0).any())
    assert int(counts[0]) == C * live.numel()
    assert nbytes == tab.table.numel() * 4 + tab.packed.numel() * 4
