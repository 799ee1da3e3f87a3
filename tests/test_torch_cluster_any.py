"""The warp-wide any hits of the clustered kernels (clustered_any,
plucker_any) on a CPU: the identities their design rests on, each held
exactly, on numpy-seeded scenes and rays.

- A warp tests a cluster's slots for one ray at once and ends the lane at
  the lowest set bit of the ballot of valid slots, counting the tests up to
  it and one accepted test (n tests without one): that must equal
  ``Lanes.accept``'s any branch on every cluster a lane enters.
- The Plücker any hit skips a group of 16 chop clusters whose box no open
  lane enters on the lane's fixed bound tmax: every lane that enters a
  chop box on that bound must enter its group's box.
- Its slab counter is set once a lane, k + 1 for a hit in chop cluster k
  and C without one: summed, the plain traversal's slab tests.  Its bound
  counts the slab tests and tables the group design needs
  (chip_smoke.py's plucker_any_needs).
- A lane whose Plücker t overflows to +inf with tmax = inf has no hit: the
  plain version's t < inf, which the kernel takes too.
- A CPU tensor takes the plain version and launches nothing."""

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops import plucker as tpl
from bpt_tpu_torch.ops.intersect import MT_EPSILON, T_MIN
from bpt_tpu_torch.ops.kernels import cluster_wave as tcw
from bpt_tpu_torch.ops.kernels import plucker as tkp
from bpt_tpu_torch.scene import builder
from test_torch_cluster_closest import _lanes, _scene, _soup
from torch_parity import big_scene

import chip_smoke


def _warp_take_first(valid):
    """cluster_hit.cuh::warp_take_first for each lane (column) of one
    cluster: the ballot of the valid slots and its lowest set bit.
    Returns (tests, taken, first valid slot or -1)."""
    n = valid.shape[0]
    vm = (valid.to(torch.int64) << torch.arange(n)[:, None]).sum(dim=0)
    taken = vm != 0
    first = torch.where(taken, torch.log2((vm & -vm).double()).long(), -1)
    return torch.where(taken, first + 1, n), taken, first


@pytest.mark.parametrize("kind", ["production", "finite tmax", "tmin below T_MIN", "ties"])
@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_warp_take_first_equals_accept(impl, kind, monkeypatch):
    """For every cluster a lane enters in the plain any traversal, the warp
    form's take ends the lanes that ``Lanes.accept`` ends, at its
    triangle, with its triangle tests and accepted tests."""
    scene = {"ties": lambda: chip_smoke.dup_scene("cpu"),
             "tmin below T_MIN": lambda: big_scene(builder, device="cpu")}.get(
        kind, lambda: _soup(40 * 32 + 7, seed=8))()
    o, d, tmin, tmax = _lanes(kind, 41)
    accept = tcw.Lanes.accept
    seen = {"clusters": 0, "taken": 0, "not first": 0}

    def checked(self, L, valid, t, u, v, ids):
        assert self.any_hit and bool(self.open[L].all())
        before = self.counts.clone()
        tests, taken, first = _warp_take_first(valid)
        accept(self, L, valid, t, u, v, ids)
        assert torch.equal(self.counts[2] - before[2], tests.sum())
        assert torch.equal(self.counts[3] - before[3], taken.sum())
        assert torch.equal(self.open[L], ~taken)
        assert torch.equal(self.tri[L][taken], ids[first[taken]])
        assert bool((self.tri[L][~taken] == -1).all())
        seen["clusters"] += L.numel()
        seen["taken"] += int(taken.sum())
        seen["not first"] += int((first > 0).sum())

    monkeypatch.setattr(tcw.Lanes, "accept", checked)
    plain = tcw.clustered_any_plain if impl == "roll" else tkp.plucker_any_plain
    hit, counts = plain(scene, o, d, tmin, tmax)
    assert seen["taken"] == int(hit.sum()) == int(counts[3]) > 0
    assert seen["clusters"] > seen["taken"] and seen["not first"] > 0


@pytest.mark.parametrize("planes", [False, True], ids=["random", "on box planes"])
def test_group_box_holds_its_members_on_tmax(planes):
    """On the any hit's bound tmax, a lane entering a chop cluster's box
    enters its group's box: so a group no open lane enters holds no
    entered cluster.  With ``planes``, each origin lies on a plane of a
    chop box and that axis' direction component is zero (NaN slab terms);
    tmax is finite, inf or below a box's entry."""
    scene = _soup(40 * 32 + 7, seed=8)
    tab = tpl.pack_plucker_clusters(scene)
    boxes = tab.aabb.reshape(-1, 6)
    groups = tab.table[tab.n_clusters * 6:].reshape(-1, 6)
    g = np.random.default_rng(10)
    n = 2048
    o = g.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    if planes:
        k = g.integers(0, tab.n_clusters, n)
        for i in range(n):
            a = i % 3
            o[i, a] = float(boxes[k[i], a + 3 * (i // 3 % 2)])
            d[i, a] = 0.0
    tmax = g.uniform(0.05, 6.0, n).astype(np.float32)
    tmax[::5] = np.inf
    st = tcw.Lanes(Vec3(*torch.from_numpy(o).unbind(1)), Vec3(*torch.from_numpy(d).unbind(1)),
                   torch.full((n,), T_MIN), torch.from_numpy(tmax), any_hit=True)
    lanes = torch.arange(n)
    entered = 0
    for c in range(tab.n_clusters):
        inner = set(st.entering(boxes[c], lanes).tolist())
        outer = set(st.entering(groups[c // tpl.GROUP], lanes).tolist())
        assert inner <= outer
        entered += len(inner)
    assert entered > 0


@pytest.mark.parametrize("which", ["big", "mixed", "partial last group"])
def test_plucker_any_slab_counter_and_needs(which):
    """The Plücker any hit's slab counter, k + 1 for a lane whose first hit
    is in chop cluster k and C for a lane without one, summed over the live
    lanes, is the plain traversal's; and chip_smoke.py's
    plucker_any_needs counts each live lane's group boxes up to its hit's
    group and the members it tests in each group it enters (on tmax) up to
    its hit, and the bytes of ``table`` and ``packed``."""
    scene = _scene(which)
    tab = tpl.pack_plucker_clusters(scene)
    C, G = tab.n_clusters, tab.n_groups
    o, d, tmin, tmax = _lanes("finite tmax", 7)
    st = tkp._plucker(scene, o, d, tmin, tmax, any_hit=True)
    live = torch.nonzero(tmax > 0).flatten()
    tri = st.tri[live]
    assert bool((tri >= 0).any()) and bool((tri < 0).any())
    assert int(st.counts[0]) == int(torch.where(tri >= 0, tri // 32 + 1, C).sum())
    slabs, nbytes = chip_smoke.plucker_any_needs(tab.aabb, o, d, tmax, st.tri, chunk=100)
    lanes = tcw.Lanes(o, d, tmin, tmax, any_hit=True)
    hit_g = torch.where(tri >= 0, tri // 32 // tpl.GROUP, G)
    want = int(torch.clamp(hit_g + 1, max=G).sum())
    for g, box in enumerate(tab.table[C * 6:].reshape(G, 6)):
        inside = set(lanes.entering(box, live).tolist())
        for lane, k, hg in zip(live.tolist(), (tri // 32).tolist(), hit_g.tolist()):
            if lane in inside and g <= hg:
                want += min(tpl.GROUP, C - g * tpl.GROUP) if g < hg else k - g * tpl.GROUP + 1
    assert slabs == want
    assert nbytes == tab.table.numel() * 4 + tab.packed.numel() * 4


def test_overflowing_t_is_no_hit():
    """chip_smoke.py's overflow lane: in the chop cluster of the big
    triangle its Plücker test passes |denom| >= MT_EPSILON and every sign
    test with t = pn / denom = +inf, and tmax = inf; the plain any hit
    (t < inf, as the kernel and bpt_tpu's t < t_best = inf) answers no hit,
    and so does the closest hit."""
    scene = chip_smoke.overflow_scene("cpu")
    o, d = (torch.from_numpy(x)[None] for x in chip_smoke.overflow_lane())
    O, D = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
    tmin, tmax = torch.tensor([T_MIN]), torch.tensor([torch.inf])
    tab = tpl.pack_plucker_clusters(scene)
    st = tcw.Lanes(O, D, tmin, tmax, any_hit=True)
    passed = []
    for c, box in enumerate(tab.aabb.reshape(-1, 6)):
        if not st.entering(box, torch.arange(1)).numel():
            continue
        p = o - (box[:3] + box[3:]) * 0.5
        f = torch.cat([d, torch.cross(p, d, dim=1), -p, torch.ones(1, 1)], dim=1)[0]
        w = tab.blocks[c, :, 0] * f[0]
        for k in range(1, tpl.NFEAT):
            w = w + tab.blocks[c, :, k] * f[k]
        w_ab, w_bc, w_ca, pn = w.split(32)
        denom = w_ab + w_bc + w_ca
        pos = denom > 0.0
        agree = lambda x: ((x >= 0.0) & pos) | ((x <= 0.0) & ~pos)
        ok = ((denom.abs() >= MT_EPSILON) & agree(w_ca) & agree(w_ab) & agree(w_bc)
              & agree(w_ab + w_bc))
        passed += (pn * (1.0 / denom))[ok].tolist()
    assert passed == [torch.inf]
    hit, counts = tkp.plucker_any_plain(scene, O, D, tmin, tmax)
    assert not bool(hit[0]) and int(counts[2]) > 0 and int(counts[3]) == 0
    assert int(tkp.plucker_closest_plain(scene, O, D, tmin, tmax)[1][0]) == -1


@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_cpu_lanes_take_the_plain_any(impl):
    """A CPU tensor takes the plain any hit, and the wrapper's launch count
    stays at 0."""
    kern, plain = ((tcw.clustered_any, tcw.clustered_any_plain) if impl == "roll" else
                   (tkp.plucker_any, tkp.plucker_any_plain))
    scene = big_scene(builder, device="cpu")
    o, d, tmin, tmax = _lanes("finite tmax", 5)
    launches, calls = kern.launches, plain.calls
    got = kern(scene, o, d, tmin, tmax)
    assert (kern.launches, plain.calls) == (launches, calls + 1) and launches == 0
    want = plain(scene, o, d, tmin, tmax)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[0].any()) and not bool(got[0][::9].any())


def test_chip_smoke_reads_the_warp_wide_any_kernels_ptxas_lines():
    """chip_smoke.py's kernels line takes the warp-wide any hits'
    registers and spill bytes (cluster_any<...> over the compacted lanes,
    its int32 scratch a second argument), not their compaction kernels'
    (cluster_live<..., true>), and a thread-a-lane build's cluster_any."""
    def entry(name, regs, spill):
        return [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                f"ptxas info    : Used {regs} registers, used 1 barriers, 380 bytes cmem[0]"]

    log = (entry("_ZN3bpt12cluster_liveINS_8RolledMTELb1EEEvNS_16ClusterHitParamsEPi", 14, 0)
           + entry("_ZN3bpt11cluster_anyINS_8RolledMTEEEvNS_16ClusterHitParamsEPi", 64, 0)
           + entry("_ZN3bpt12cluster_liveINS_11PluckerChopELb1EEEvNS_16ClusterHitParamsEPi",
                   14, 0)
           + entry("_ZN3bpt11cluster_anyINS_11PluckerChopEEEvNS_16ClusterHitParamsEPi", 72, 4))
    got = chip_smoke.cluster_ptxas(log)
    assert {k: (v["registers"], v["spill_bytes"]) for k, v in got.items()} == {
        "clustered_any": (64, [0, 0]), "plucker_any": (72, [4, 4])}
    parent = chip_smoke.cluster_ptxas(
        entry("_ZN3bpt11cluster_anyINS_11PluckerChopEEEvNS_16ClusterHitParamsE", 48, 0))
    assert {k: v["registers"] for k, v in parent.items()} == {"plucker_any": 48}
