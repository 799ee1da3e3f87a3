"""The clustered hit kernels of bpt_tpu_torch (Pallas kernels 10-13: the
rolled and the Plücker clustered closest and any hit) and the dispatch that
reaches them, against bpt_tpu on a CPU, on the same numpy-seeded inputs:
the cluster splits and tables, the sort key, each plain version against
its Pallas kernel in interpret mode, ``ops.soa.closest_hit`` / ``any_hit``
against bpt_tpu's TPU dispatch forced on a CPU, and the BDPT wave route
through the clustered plain versions.

Tolerances, the reference tests' own (tests/test_pallas_kernels.py:
483-647): hits and any-answers exact, triangle ids exact off ties; t
within rtol 2e-5, u and v within rtol 1e-4 / atol 1e-5 for the rolled
kernels; t within rtol 1e-4, u and v within rtol 1e-3 / atol 1e-4 for the
Plücker kernels, whose products the port sums in another order than the
TPU's matrix unit.  A tie: the ray passes through an edge that two
triangles share, both accepting it within the comparison's rtol; which of
them wins then depends on rounding.  The one difference of the port by
design, per-lane culling where the TPU culls a 128-lane row: a Plücker
lane whose tmin lies below T_MIN can find a hit behind T_MIN in a cluster
its own slab test does not enter, when another lane of its TPU tile enters
it (ROADMAP §3)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.ops.pallas import cluster_wave as jcw
from bpt_tpu.ops.pallas import clusters as jcl
from bpt_tpu.ops.pallas import plucker as jpl
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import render as trender_mod
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops import clusters as tcl
from bpt_tpu_torch.ops import plucker as tpl
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import cluster_wave as tcw
from bpt_tpu_torch.ops.kernels import plucker as tkp
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_rays, big_scene, to_port

B = 257  # not a multiple of the TPU kernels' 128-lane rows
KINDS = ("production", "finite_tmax", "tmin_above", "tmin_below", "dead")
TOL = {"roll": dict(t=2e-5, uv=(1e-4, 1e-5)), "plucker": dict(t=1e-4, uv=(1e-3, 1e-4))}
PALLAS = {"roll": (jcw.clustered_closest_pallas, jcw.clustered_any_pallas),
          "plucker": (jpl.plucker_closest_pallas, jpl.plucker_any_pallas)}
PLAIN = {"roll": (tcw.clustered_closest_plain, tcw.clustered_any_plain),
         "plucker": (tkp.plucker_closest_plain, tkp.plucker_any_plain)}


@pytest.fixture(scope="module")
def scenes():
    js = big_scene(jbuilder, dtype=jnp.float32)
    return js, to_port(js)


@pytest.fixture(scope="module")
def jtables(scenes):
    js = scenes[0]
    return {"roll": jcl.pack_clusters_rolled(js)[1:], "plucker": jpl.pack_plucker_clusters(js)[1:]}


def _lanes(kind, seed=11):
    """big_rays (zero direction components on the first lanes, origins on
    the x = 0 plane of the sphere's boxes on the first four) with per-lane
    [tmin, tmax] of the given kind."""
    o, d = big_rays(B, seed)
    g = np.random.default_rng(seed + 1)
    tmin = np.full(B, T_MIN, np.float32)
    tmax = np.full(B, np.inf, np.float32)
    if kind == "finite_tmax":
        tmax = g.uniform(0.5, 4.0, B).astype(np.float32)
        tmax[::7] = np.inf
    elif kind == "tmin_above":
        tmin = g.uniform(0.3, 2.0, B).astype(np.float32)
    elif kind == "tmin_below":  # hits behind the origin, back to t = -1
        tmin = np.full(B, -1.0, np.float32)
        tmin[::3] = 0.0
    elif kind == "dead":
        tmax[::4] = 0.0
        tmax[1::8] = -1.0
    return o, d, tmin, tmax


def _tvec(a):
    return Vec3(*torch.from_numpy(np.ascontiguousarray(a)).unbind(1))


def _jvec(a):
    return jv3.from_array(jnp.asarray(a))


def _ties(scene, o, d, tmin, tmax, impl, rtol):
    """Lanes whose closest t two or more triangles give within rtol (the
    ray through a shared edge), by Möller–Trumbore over every triangle."""
    det, t, u, v = tsoa._mt_all(scene.v0, scene.e1, scene.e2, _tvec(o), _tvec(d))
    lo = torch.from_numpy(tmin)[None]
    if impl == "roll":
        lo = torch.clamp_min(lo, T_MIN)
    ok = tsoa._mt_valid(det, t, u, v, lo, torch.from_numpy(tmax)[None])
    tm = torch.where(ok, t, torch.inf)
    best = tm.amin(dim=0)
    near = ok & ((tm - best).abs() <= rtol * best.abs() + 1e-12)
    return (near.sum(dim=0) >= 2).numpy()


def _not_entered(scene, o, d, tri):
    """Per lane: the lane's own slab test (unbounded exit, entry clamped to
    T_MIN) misses the box of the chop cluster of triangle tri."""
    box = tpl.chop_aabbs(scene, -(-scene.num_tris // 32)).reshape(-1, 6)
    st = tcw.Lanes(_tvec(o), _tvec(d), torch.zeros(len(tri)), torch.full((len(tri),), torch.inf),
                   any_hit=True)
    out = []
    for k, c in enumerate(np.asarray(tri) // 32):
        lane = torch.tensor([k])
        out.append(st.entering(box[c], lane).numel() == 0)
    return np.array(out)


def test_splits_match_bpt_tpu():
    """The port's builder computes bpt_tpu's subtree splits, and a bpt_tpu
    scene carried across keeps them."""
    js = big_scene(jbuilder, dtype=jnp.float32)
    ts = big_scene(tbuilder, device="cpu")
    assert ts.cluster_splits == js.cluster_splits and ts.super_splits == js.super_splits
    assert len(ts.cluster_splits) > 2 and len(ts.super_splits) > 2
    carried = to_port(js)
    assert carried.cluster_splits == js.cluster_splits
    assert carried.super_splits == js.super_splits


def test_tables_match_bpt_tpu(scenes, jtables):
    """The combined table exactly, the triangle blocks as the un-replicated
    rows of bpt_tpu's, the Plücker boxes exactly and the Plücker blocks'
    first 10 features within 1e-6."""
    ts = scenes[1]
    tab = tcl.cluster_tables(ts)
    table, blocks = jtables["roll"]
    np.testing.assert_array_equal(tab.table.numpy(), np.asarray(table))
    np.testing.assert_array_equal(tab.blocks.numpy(),
                                  np.asarray(blocks)[:, :9, :32].transpose(0, 2, 1))
    assert (tab.n_super, tab.n_clusters) == (len(ts.super_splits) - 1, len(ts.cluster_splits) - 1)
    aabb, pblocks = jtables["plucker"]
    ptab = tpl.pack_plucker_clusters(ts)
    np.testing.assert_array_equal(ptab.aabb.numpy(), np.asarray(aabb))
    np.testing.assert_allclose(ptab.blocks.numpy(), np.asarray(pblocks)[:, :, :tpl.NFEAT],
                               rtol=0, atol=1e-6)


def test_tables_are_packed_once_a_scene():
    """Both kernels' tables are packed at a scene's first hit call, reused
    by every later one, and dropped with the scene."""
    import gc

    ts = big_scene(tbuilder, device="cpu")
    tab, ptab = tcl.cluster_tables(ts), tpl.plucker_tables(ts)
    assert tcl.cluster_tables(ts) is tab and tpl.plucker_tables(ts) is ptab
    assert tab.blocks.shape == (tab.n_clusters, 32, 9)
    assert ptab.blocks.shape == (ptab.n_clusters, 128, tpl.NFEAT)
    key = id(ts)
    del ts
    gc.collect()
    assert key not in tcl.cluster_tables.cache and key not in tpl.plucker_tables.cache


def test_chop_fallback_matches_bpt_tpu(scenes):
    """A scene without splits takes bpt_tpu's fixed-stride chop."""
    import dataclasses

    js, ts = scenes
    want = jcl._splits_of(dataclasses.replace(js, cluster_splits=(), super_splits=()))
    assert tcl.splits_of(dataclasses.replace(ts, cluster_splits=(), super_splits=())) == want


def test_morton_octant_key_matches_bpt_tpu(scenes):
    js, ts = scenes
    o, d = big_rays(B, 3)
    o[5] = [-100.0, 100.0, 0.0]  # clamped into the box
    lo, hi = js.bvh_min[0].astype(jnp.float32), js.bvh_max[0].astype(jnp.float32)
    want = np.asarray(jcw.morton_octant_key(lo, hi, *jnp.asarray(o.T), *jnp.asarray(d.T)))
    got = tcw.morton_octant_key(ts.bvh_min[0], ts.bvh_max[0], *torch.from_numpy(o.T),
                                *torch.from_numpy(d.T))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hit", ["closest", "any"])
@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_plain_matches_pallas_interpret(scenes, jtables, impl, hit, kind):
    ts = scenes[1]
    o, d, tmin, tmax = _lanes(kind)
    args = [jnp.asarray(x) for x in (*o.T, *d.T, tmin, tmax)]
    fn = PALLAS[impl][hit == "any"]
    want = fn(*jtables[impl], *args, interpret=True)
    plain = PLAIN[impl][hit == "any"]
    n = plain.calls
    got = plain(ts, _tvec(o), _tvec(d), torch.from_numpy(tmin), torch.from_numpy(tmax))
    assert plain.calls == n + 1
    counts = got[-1].tolist()
    live = tmax > 0
    if hit == "any":
        want_hit, got_hit = np.asarray(want), got[0].numpy()
        differ = want_hit != got_hit
        assert counts[3] == int(got_hit.sum())
    else:
        wt, wtri, wu, wv = (np.asarray(x) for x in want)
        gt, gtri, gu, gv = (x.numpy() for x in got[:4])
        want_hit, got_hit = np.isfinite(wt), gtri >= 0
        differ = (want_hit != got_hit) | ~np.isclose(gt, wt, rtol=TOL[impl]["t"], atol=0)
        assert np.array_equal(np.isfinite(gt), got_hit)
        assert (gtri[~live] == -1).all()
    if impl == "plucker" and kind == "tmin_below" and differ.any():
        # the TPU's row cull: bpt_tpu's hit lies behind T_MIN, in a chop
        # cluster this lane's own slab test does not enter
        lanes = np.nonzero(differ)[0]
        print(f"{impl} {hit} {kind}: {lanes.size} lanes differ from the Pallas kernel by "
              f"its row cull: {lanes.tolist()}")
        if hit == "closest":
            assert (wt[lanes] < T_MIN).all() and (np.isinf(gt[lanes]) | (wt[lanes] < gt[lanes])).all()
            assert _not_entered(ts, o[lanes], d[lanes], wtri[lanes]).all()
        else:
            assert want_hit[lanes].all() and not got_hit[lanes].any()
        keep = ~differ
    else:
        assert not differ.any(), np.nonzero(differ)[0]
        keep = np.ones(B, bool)
    assert counts[0] >= counts[1] > 0 and counts[2] >= counts[3] > 0
    if hit == "any":
        return
    both = want_hit & got_hit & keep
    np.testing.assert_allclose(gt[both], wt[both], rtol=TOL[impl]["t"])
    rtol, atol = TOL[impl]["uv"]
    np.testing.assert_allclose(gu[both], wu[both], rtol=rtol, atol=atol)
    np.testing.assert_allclose(gv[both], wv[both], rtol=rtol, atol=atol)
    ties = _ties(ts, o, d, tmin, tmax, impl, TOL[impl]["t"])
    off = both & ~ties
    np.testing.assert_array_equal(gtri[off], wtri[off])
    assert off.sum() > 0.8 * both.sum() and counts[3] >= int(got_hit.sum())


def _jax_dispatch(monkeypatch):
    """bpt_tpu's TPU dispatch on a CPU, over interpret-mode kernels
    (tests/test_intersect.py:178-215)."""
    import os

    monkeypatch.setattr(jsoa, "_on_tpu", lambda: True)

    def impls():
        if os.environ.get("BPT_TPU_WAVE_IMPL", "roll") == "plucker":
            return (jpl.pack_plucker_clusters,
                    functools.partial(jpl.plucker_closest_pallas, interpret=True),
                    functools.partial(jpl.plucker_any_pallas, interpret=True))
        return (jcl.pack_clusters_rolled,
                functools.partial(jcw.clustered_closest_pallas, interpret=True),
                functools.partial(jcw.clustered_any_pallas, interpret=True))

    monkeypatch.setattr(jsoa, "_wave_impls", impls)
    # the port's card dispatch on a CPU scene, through the plain versions
    monkeypatch.setattr(tsoa, "_card_bvh", lambda scene: scene.use_bvh)


CASES = [("", "general"), ("BPT_TPU_NO_FTB", "production"), ("BPT_TPU_NO_FTB", "general"),
         ("BPT_TPU_WAVE_IMPL", "production"), ("BPT_TPU_WAVE_IMPL", "general")]


@pytest.mark.parametrize("switch,interval", CASES)
def test_dispatch_matches_bpt_tpu(scenes, monkeypatch, switch, interval):
    """ops.soa.closest_hit / any_hit / any_hit_counted on the clustered
    route against bpt_tpu's dispatch: hits, t, triangles off ties and the
    four counters."""
    js, ts = scenes
    _jax_dispatch(monkeypatch)
    if switch:
        monkeypatch.setenv(switch, "plucker" if switch == "BPT_TPU_WAVE_IMPL" else "1")
    impl = "plucker" if switch == "BPT_TPU_WAVE_IMPL" else "roll"
    o, d = big_rays(B, 21)
    g = np.random.default_rng(22)
    mask = g.uniform(size=B) > 0.2
    if interval == "production":
        tmin, tmax, jtmin, jtmax = T_MIN, np.inf, T_MIN, np.inf
        assert tsoa.wave_impl(tmin, tmax) == impl and tsoa.wave_impl(tmin) == impl
    else:
        a = g.uniform(T_MIN, 0.5, B).astype(np.float32)
        b = g.uniform(1.0, 6.0, B).astype(np.float32)
        b[::5] = np.inf
        tmin, tmax, jtmin, jtmax = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    plain = PLAIN[impl]
    calls = [f.calls for f in plain]
    walks = tsoa.bvh_closest.calls + tsoa.bvh_any.calls
    want = jsoa.closest_hit(js, _jvec(o), _jvec(d), jtmin, jtmax, mask=jnp.asarray(mask))
    got = tsoa.closest_hit(ts, _tvec(o), _tvec(d), tmin, tmax, mask=torch.from_numpy(mask))
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert not got.hit.numpy()[~mask].any() and 0.2 < hit.mean() < 0.9
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=TOL[impl]["t"])
    assert np.isinf(got.t.numpy()[~hit]).all()
    ties = _ties(ts, o, d, np.broadcast_to(np.float32(tmin), B).copy(),
                 np.where(mask, np.broadcast_to(np.float32(tmax), B), 0).astype(np.float32),
                 impl, TOL[impl]["t"])
    np.testing.assert_array_equal(got.tri.numpy()[hit & ~ties], np.asarray(want.tri)[hit & ~ties])
    counts = [int(x) for x in (got.node_visits, got.aabb_hits, got.tri_tests, got.tri_hits)]
    assert counts == [int(x) for x in (want.node_visits, want.aabb_hits, want.tri_tests,
                                       want.tri_hits)]
    assert counts == [0, 0, int(mask.sum()) * ts.num_tris, int(hit.sum())]
    jany = np.asarray(jsoa.any_hit(js, _jvec(o), _jvec(d), jtmin, jtmax, mask=jnp.asarray(mask)))
    tany, c = tsoa.any_hit_counted(ts, _tvec(o), _tvec(d), tmin, tmax, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tany.numpy(), jany)
    assert c.tolist() == [0, 0, int(mask.sum()) * ts.num_tris]
    assert [f.calls - n for f, n in zip(plain, calls)] == [1, 1]
    assert tsoa.bvh_closest.calls + tsoa.bvh_any.calls == walks


@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_sorted_route_equals_unsorted(scenes, monkeypatch, impl):
    """The dispatch's Morton sort and its inverse change no lane's answer:
    closest_hit equals the plain version called on the lanes unsorted."""
    ts = scenes[1]
    monkeypatch.setattr(tsoa, "_card_bvh", lambda scene: scene.use_bvh)
    if impl == "plucker":
        monkeypatch.setenv("BPT_TPU_WAVE_IMPL", "plucker")
    o, d, tmin, tmax = _lanes("finite_tmax", seed=31)
    ov, dv, a, b = _tvec(o), _tvec(d), torch.from_numpy(tmin), torch.from_numpy(tmax)
    h = tsoa.closest_hit(ts, ov, dv, a, b, plain=True)
    t, tri, u, v, _ = PLAIN[impl][0](ts, ov, dv, a, b)
    assert torch.equal(h.hit, tri >= 0) and torch.equal(h.t, t)
    assert torch.equal(h.tri, torch.clamp_min(tri, 0).long())
    assert torch.equal(h.u, u) and torch.equal(h.v, v)
    assert torch.equal(tsoa.any_hit(ts, ov, dv, a, b), PLAIN[impl][1](ts, ov, dv, a, b)[0])


@pytest.fixture(scope="module")
def wave_renders():
    """The port's BDPT wave route (bdpt_jnp) on the big scene at 8x8, 4
    spp, depth 3, bdpt-mis: through the default walk, and through the
    clustered plain versions under each switch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(trender_mod, "WAVE_MIN_RAYS", 1)
    ts = big_scene(tbuilder, device="cpu")
    cfg = CameraConfig(image_width=8, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
                       vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0),
                       integrator="bdpt-mis")
    assert trender_mod._route(ts, cfg, "bdpt-mis", None) == "bdpt_wave"
    out = {"walk": render(ts, cfg, seed=4)}
    mp.setattr(tsoa, "_card_bvh", lambda scene: scene.use_bvh)
    for impl, (var, val) in (("roll", ("BPT_TPU_NO_FTB", "1")),
                             ("plucker", ("BPT_TPU_WAVE_IMPL", "plucker"))):
        mp.setenv(var, val)
        calls = [f.calls for f in PLAIN[impl]]
        walks = tsoa.bvh_closest.calls + tsoa.bvh_any.calls
        out[impl] = render(ts, cfg, seed=4)
        # depth 3: 5 closest hits (3 camera, 2 light bounces), 3 shadow waves
        assert [f.calls - n for f, n in zip(PLAIN[impl], calls)] == [5, 3]
        assert tsoa.bvh_closest.calls + tsoa.bvh_any.calls == walks
        mp.delenv(var)
    mp.undo()
    return out


@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_bdpt_wave_through_clustered_route(wave_renders, impl):
    walk, got = wave_renders["walk"], wave_renders[impl]
    fb, ref = got.framebuffer_sum, walk.framebuffer_sum
    assert np.isfinite(fb).all() and float(ref.mean()) > 0.0
    differ = int((np.abs(fb - ref) > 1e-6).any(axis=-1).sum())
    print(f"{impl}: rays {got.stats.rays_traced} (walk {walk.stats.rays_traced}), shadow "
          f"{got.stats.shadow_rays} (walk {walk.stats.shadow_rays}); {differ} of "
          f"{fb.shape[0] * fb.shape[1]} pixels differ by more than 1e-6")
    if impl == "roll":
        assert got.stats.rays_traced == walk.stats.rays_traced
        assert got.stats.shadow_rays == walk.stats.shadow_rays
        np.testing.assert_allclose(fb, ref, rtol=0, atol=1e-6)
    else:
        assert abs(got.stats.rays_traced - walk.stats.rays_traced) <= 0.02 * walk.stats.rays_traced
    assert got.stats.triangle_tests > walk.stats.triangle_tests  # T tests a live lane
