"""bpt_tpu_torch's large-scene PT against bpt_tpu: the BVH walk
(``ops.soa.bvh_closest``, the plain version of the CUDA ``closest_bvh``),
the coherence sort key, ``pt_wave`` (plain versions of the CUDA wave
kernels) against bpt_tpu's Pallas ``pt_wave`` in interpret mode, and the
``render()`` route that takes it.

Tolerances: hits, triangle ids and the four walk counters exact at f64
and f32; t, u, v to 1e-12 (f64) and 1e-5 relative (f32), because XLA's
CPU backend contracts a*b+c in Möller–Trumbore and PyTorch does not.
pt_wave radiance within 1e-6 and rays exact; bpt_tpu's
own pt_wave is bit-equal to its fused kernel on the same stream, and the
port's render through pt_wave is bit-equal to its fused plain version."""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.ops.pallas import pt_wave as jwave
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.models.render import _wave_spp_batch, render
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_rays, big_scene

COUNTERS = ("node_visits", "aabb_hits", "tri_tests", "tri_hits")


@pytest.fixture(scope="module")
def port_scene():
    return big_scene(tbuilder, device="cpu")


def _tvec(a):
    return Vec3(*torch.from_numpy(a).unbind(1))


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_bvh_closest_matches_bpt_tpu(dt):
    jdt, tdt, npdt = ((jnp.float64, torch.float64, np.float64) if dt == "f64"
                      else (jnp.float32, torch.float32, np.float32))
    js = big_scene(jbuilder, dtype=jdt)
    ts = big_scene(tbuilder, device="cpu", dtype=tdt)
    o, d = (x.astype(npdt) for x in big_rays(512, 5))
    tmax = np.where(np.arange(512) % 7 == 0, 2.0, np.inf).astype(npdt)
    want = jsoa.bvh_closest(js, jv3.from_array(jnp.asarray(o)),
                            jv3.from_array(jnp.asarray(d)), T_MIN, jnp.asarray(tmax))
    got = tsoa.bvh_closest(ts, _tvec(o), _tvec(d), T_MIN, torch.from_numpy(tmax))
    assert [int(getattr(got, c)) for c in COUNTERS] == [
        int(getattr(want, c)) for c in COUNTERS]
    hit = np.asarray(want.hit)
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    rtol = 1e-12 if dt == "f64" else 1e-5
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit], rtol=rtol,
                                   atol=rtol, err_msg=f)
    assert np.isinf(got.t.numpy()[~hit]).all()


def test_closest_hit_takes_the_bvh_with_masked_counters(port_scene):
    """soa.closest_hit on a use_bvh scene walks the BVH and leaves culled
    lanes out of every counter, as bpt_tpu's does on a CPU."""
    js = big_scene(jbuilder, dtype=jnp.float32)
    o, d = big_rays(300, 6)
    mask = np.arange(300) % 5 != 0
    want = jsoa.closest_hit(js, jv3.from_array(jnp.asarray(o)),
                            jv3.from_array(jnp.asarray(d)), T_MIN, jnp.inf,
                            mask=jnp.asarray(mask))
    got = tsoa.closest_hit(port_scene, _tvec(o), _tvec(d), T_MIN, torch.inf,
                           mask=torch.from_numpy(mask))
    assert [int(getattr(got, c)) for c in COUNTERS] == [
        int(getattr(want, c)) for c in COUNTERS]
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert not got.hit.numpy()[~mask].any()


def test_closest_bvh_wrapper_takes_the_plain_version_on_cpu(port_scene):
    o, d = big_rays(200, 7)
    active = torch.from_numpy(np.arange(200) % 3 != 0)
    n, k = tw.closest_bvh_plain.calls, tw.closest_bvh.launches
    t, tri, u, v, counters = tw.closest_bvh(port_scene, _tvec(o), _tvec(d), active)
    assert tw.closest_bvh_plain.calls == n + 1 and tw.closest_bvh.launches == k
    h = tsoa.closest_hit(port_scene, _tvec(o), _tvec(d), T_MIN, torch.inf, mask=active)
    np.testing.assert_array_equal(tri.numpy(), np.where(h.hit, h.tri, -1))
    np.testing.assert_array_equal(t.numpy(), h.t.numpy())
    assert tri.dtype == torch.int32 and (tri[~active] == -1).all()
    assert counters.tolist() == [int(getattr(h, c)) for c in COUNTERS]


def test_walk_tables_are_packed_once_a_scene():
    """The hit kernels' nodes and triangles are packed at the first
    traversal of a scene, reused by every later one, and dropped with the
    scene."""
    scene = big_scene(tbuilder, device="cpu")
    nodes, tris = tw.walk_tables(scene)
    assert tw.walk_tables(scene)[0] is nodes and tw.pack_bvh(scene).tris is tris
    assert nodes.shape == (scene.bvh_skip.shape[0], 8) and tris.shape == (scene.num_tris, 12)
    ints = nodes[:, 6:].view(torch.int32)
    assert torch.equal(ints[:, 0], scene.bvh_skip.to(torch.int32))
    assert torch.equal(ints[:, 1], (scene.bvh_first * 4 + scene.bvh_count).to(torch.int32))
    assert torch.equal(tris[:, 9:], scene.normal.to(torch.float32))
    key = id(scene)
    del scene
    gc.collect()
    assert key not in tw.walk_tables.cache


def test_coherence_key_matches_bpt_tpu():
    g = np.random.default_rng(9)
    o = g.normal(size=(3, 1000)).astype(np.float32)
    d = g.normal(size=(3, 1000)).astype(np.float32)
    d[0, :10] = 0.0
    alive = (g.uniform(size=1000) > 0.3).astype(np.float32)
    lo = o.min(axis=1) - 0.1
    hi = o.max(axis=1) + 0.2
    want = jwave._coherence_key(*(jnp.asarray(x) for x in (lo, hi, *o, *d, alive)))
    got = tw._coherence_key(*(torch.from_numpy(x) for x in (lo, hi, *o, *d, alive)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


B_WAVE, DEPTH_WAVE = 256, 4


def _wave_inputs():
    """bpt_tpu's test_pt_wave_matches_megakernel_clustered rays, every
    17th lane inactive."""
    g = np.random.default_rng(41)
    o = np.tile([[0.0, 2.0, 6.0]], (B_WAVE, 1)).astype(np.float32)
    tgt = np.concatenate([g.uniform(-2, 2, (B_WAVE, 1)), g.uniform(0, 3, (B_WAVE, 1)),
                          np.zeros((B_WAVE, 1))], 1)
    d = (tgt - np.array([0.0, 2.0, 6.0])).astype(np.float32)
    ids = np.arange(B_WAVE, dtype=np.int32)
    ids[::17] = -1
    return o, d, ids


@pytest.fixture(scope="module")
def jax_wave():
    """bpt_tpu's pt_wave (Pallas, interpret mode) on the big scene."""
    o, d, ids = _wave_inputs()
    out = jwave.pt_wave(big_scene(jbuilder, dtype=jnp.float32),
                        jv3.from_array(jnp.asarray(o)), jv3.from_array(jnp.asarray(d)),
                        jnp.asarray(ids), jax.random.fold_in(jax.random.PRNGKey(12), 1),
                        DEPTH_WAVE, interpret=True)
    return [np.asarray(x) for x in out[:3]], int(out[3])


@pytest.mark.parametrize("paged", [False, True], ids=["walk", "paged"])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_pt_wave_plain_matches_bpt_tpu(port_scene, jax_wave, paged, sort):
    o, d, ids = _wave_inputs()
    n = tw.closest_bvh_plain.calls
    got = tw.pt_wave_plain(port_scene, _tvec(o), _tvec(d), torch.from_numpy(ids),
                           rng.fold_in(rng.prng_key(12), 1), DEPTH_WAVE,
                           sort=sort, paged=paged)
    assert tw.closest_bvh_plain.calls == n + (DEPTH_WAVE if paged else 0)
    rad, rays = jax_wave
    assert got[3].dtype == torch.int64 and int(got[3]) == rays > B_WAVE
    for g, w in zip(got[:3], rad):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
        assert (g.numpy()[::17] == 0).all()
    assert float(sum(x.sum() for x in got[:3])) > 0


def test_pt_wave_on_cpu_is_the_plain_version(port_scene):
    """The kernel path on CPU tensors runs the plain bounce, bit for bit,
    counters included, and launches nothing."""
    o, d, ids = _wave_inputs()
    args = (port_scene, _tvec(o), _tvec(d), torch.from_numpy(ids), rng.prng_key(5), 3)
    n, k = tw.pt_wave_bounce_plain.calls, tw.pt_wave_bounce.launches
    got = tw.pt_wave(*args)
    assert tw.pt_wave_bounce_plain.calls == n + 3 and tw.pt_wave_bounce.launches == k
    want = tw.pt_wave_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _big_cfg(**kw):
    return dataclasses.replace(
        CameraConfig(image_width=10, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
                     vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0),
                     integrator="pt"), **kw)


def test_render_takes_pt_wave_and_matches_the_fused_plain_version(port_scene):
    """bpt_tpu's test_pt_wave_matches_megakernel_clustered, whole render:
    the pt_wave route equals pt_megakernel_pixels_plain on the same stream
    bit for bit, counters included."""
    cfg = _big_cfg()
    n = tw.pt_wave_bounce_plain.calls
    res = render(port_scene, cfg, seed=3)
    assert tw.pt_wave_bounce_plain.calls == n + cfg.max_depth  # 4 strata, one wave
    W = cfg.image_width
    pix = torch.arange(W * W)
    i, j = (pix % W).float(), (pix // W).float()
    out = pk.pt_megakernel_pixels_plain(
        port_scene, i, j, i * 0, j * 0, pix, pk.camera_table(camera_constants(cfg)),
        rng.prng_key(3), cfg.max_depth, spp_loop=4, sqrt_spp=2)
    fb = torch.stack(out[:3], -1).reshape(W, W, 3).numpy()
    np.testing.assert_array_equal(res.framebuffer_sum, fb)
    s = res.stats
    assert s.rays_traced == int(out[3])
    assert [s.bvh_node_visits, s.aabb_hits, s.triangle_tests, s.triangle_hits] == out[4].tolist()
    assert s.bvh_nodes_built == int(port_scene.bvh_skip.shape[0])


def test_render_wave_batches_and_stratum_checkpoints(port_scene, monkeypatch):
    """Batching strata into one wave changes no bit, and the wave loop's
    stratum checkpoints resume to the same image."""
    from bpt_tpu_torch.models import render as rmod

    assert _wave_spp_batch(512 * 512, 16) == 16
    assert _wave_spp_batch(4096 * 4096, 16) == 1
    cfg = _big_cfg(image_width=6)
    whole = render(port_scene, cfg, seed=4)
    monkeypatch.setattr(rmod, "_wave_spp_batch", lambda npix, spp: 1)
    snaps = []
    one = render(port_scene, cfg, seed=4, stratum_callback=snaps.append)
    np.testing.assert_array_equal(one.framebuffer_sum, whole.framebuffer_sum)
    assert [s["strata_done"] for s in snaps] == [1, 2, 3, 4]
    assert {s["unit_kind"] for s in snaps} == {"stratum"} and snaps[0]["stream"] == "wave"
    resumed = render(port_scene, cfg, seed=4, resume=snaps[1])
    np.testing.assert_array_equal(resumed.framebuffer_sum, whole.framebuffer_sum)
    # a chunk-kind checkpoint resumes on the fused loop, which walks the BVH
    assert rmod._route(port_scene, cfg, "pt", dict(snaps[1], unit_kind="chunk")) == "fused"


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_render_refuses_bdpt_on_large_scenes(port_scene, integrator):
    """What large-scene BDPT still refuses: a depth outside the CLI's
    1..80, a chunk-kind checkpoint on a route the fused loop does not
    serve (ref_vis) and a checkpoint of pt_wave's stream (ref_vis renders
    since the stratum loop came)."""
    with pytest.raises(ValueError, match="chunk-kind"):
        render(port_scene, _big_cfg(integrator=integrator, ref_vis=True),
               resume=dict(framebuffer_sum=np.zeros((10, 10, 3)), units_done=1,
                           unit_kind="chunk", chunk_size=100))
    with pytest.raises(NotImplementedError, match=r"outside 1\.\.80"):
        render(port_scene, _big_cfg(integrator=integrator, max_depth=81))
    snap = dict(framebuffer_sum=np.zeros((10, 10, 3)), strata_done=1, units_done=1,
                unit_kind="stratum", stream="wave")
    with pytest.raises(ValueError, match="jnp stream"):
        render(port_scene, _big_cfg(integrator=integrator), resume=snap)
