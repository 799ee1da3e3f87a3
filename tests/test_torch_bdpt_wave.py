"""bpt_tpu_torch's large-scene BDPT route against bpt_tpu on a CPU: the jnp
stream (``core.rng.wave_uniforms`` / ``uniform_rows``,
``models.pt.default_uniforms_fn``), the BVH any hit (``ops.soa.bvh_any``,
the plain version of the CUDA ``any_bvh``) and its dispatch, and the
``render()`` route of bdpt and bdpt-mis on a scene over 512 triangles
(``models.render._render_strata`` over ``models.bdpt.bdpt_fast``)
against ``bpt_tpu``'s CPU route for it, the jnp stratum loop.

Tolerances: the stream and the any hit exact; images to 1e-10 at f64.
Counters: rays, node visits, box hits, triangle tests and hits exact.
Shadow rays exact for bdpt-mis; for bdpt, a connection between two points
of the floor (y = 0, cosines 0 or ~1e-17) passes the cosine test on one
side and not the other, because XLA's CPU backend contracts the hit point
o + t*d into one rounding and PyTorch does not: such pairs carry no
radiance, and ``test_bdpt_shadow_counts_differ_only_on_coplanar_pairs``
holds every other pair equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import rng as jrng
from bpt_tpu.core import vec3 as jv3
from bpt_tpu.models import bdpt as jbdpt
from bpt_tpu.models import pt as jpt
from bpt_tpu.models.render import render as jrender
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene.types import CameraConfig as JCameraConfig
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.models import render as trender_mod
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_rays, big_scene

STATS = ("rays_traced", "bvh_node_visits", "aabb_hits", "triangle_tests", "triangle_hits")
DTYPES = {"f32": (jnp.float32, torch.float32, np.float32),
          "f64": (jnp.float64, torch.float64, np.float64)}
IDS = np.array([0, 1, 2, 7, 1000, 65535, 123456789, 2**31 - 1], np.int32)


def _tvec(a):
    return Vec3(*torch.from_numpy(a).unbind(1))


def _jvec(a):
    return jv3.from_array(jnp.asarray(a))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_jnp_stream_bitequal(dt):
    jdt, tdt, _ = DTYPES[dt]
    for seed, stream in ((0, 0), (7, 3), (123, 4)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
        tkey = rng.fold_in(rng.prng_key(seed), stream)
        for n in (4, 5):
            for bounce in (0, 1, 9):
                want = np.asarray(jrng.wave_uniforms(jkey, jnp.asarray(IDS), bounce, n, jdt))
                got = rng.wave_uniforms(tkey, torch.from_numpy(IDS), bounce, n, tdt)
                assert got.dtype == tdt and got.shape == (IDS.size, n)
                np.testing.assert_array_equal(got.numpy(), want)
                rows = rng.uniform_rows(tkey, torch.from_numpy(IDS), bounce, n, tdt)
                np.testing.assert_array_equal(torch.stack(rows, 1).numpy(), want)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_default_uniforms_fn_rows_match(dt):
    jdt, tdt, _ = DTYPES[dt]
    want = jpt.default_uniforms_fn(jax.random.PRNGKey(3), jnp.asarray(IDS), jdt)
    got = tpt.default_uniforms_fn(rng.prng_key(3), torch.from_numpy(IDS), tdt)
    for bounce, n in ((0, 5), (4, 5), (2, 3)):
        for g, w in zip(got(bounce, n), want(bounce, n)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _shadow_lanes(B, seed, npdt):
    """big_rays with a random tmax, one lane in eight dead (tmax 0 or < 0)."""
    o, d = (x.astype(npdt) for x in big_rays(B, seed))
    tmax = np.random.default_rng(seed).uniform(0.1, 6.0, B).astype(npdt)
    tmax[::8] = 0.0
    tmax[4::16] = -1.0
    return o, d, tmax


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_bvh_any_matches_bpt_tpu(dt):
    jdt, tdt, npdt = DTYPES[dt]
    o, d, tmax = _shadow_lanes(600, 3, npdt)
    want = np.asarray(jsoa.bvh_any(big_scene(jbuilder, dtype=jdt), _jvec(o), _jvec(d),
                                   T_MIN, jnp.asarray(tmax)))
    ts = big_scene(tbuilder, device="cpu", dtype=tdt)
    n = tsoa.bvh_any.calls
    got, counters = tsoa.bvh_any(ts, _tvec(o), _tvec(d), T_MIN, torch.from_numpy(tmax))
    assert tsoa.bvh_any.calls == n + 1
    assert 0.05 < want.mean() < 0.6
    np.testing.assert_array_equal(got.numpy(), want)
    # a dead lane counts nothing: the live lanes alone count the same
    live = tmax > 0.0
    _, c_live = tsoa.bvh_any(ts, _tvec(o[live]), _tvec(d[live]), T_MIN,
                             torch.from_numpy(tmax[live]))
    assert counters.tolist() == c_live.tolist()
    nv, ah, tt, th = counters.tolist()
    assert nv > ah > tt >= th >= int(want.sum()) > 0


@pytest.mark.parametrize("case", ["B=1", "all dead", "one live lane", "all live"])
def test_any_bvh_wrapper_lanes_match_bpt_tpu(case):
    """``any_bvh`` on a CPU tensor (its plain version) on the lane shapes
    the card's refilling grid is tested at: answers equal to bpt_tpu's
    bvh_any, a dead lane a miss that counts nothing, so the counters are
    those of the live lanes alone."""
    B = 1 if case == "B=1" else 257
    o, d, tmax = _shadow_lanes(B, 17, np.float32)
    if case == "all dead":
        tmax[:] = 0.0
    elif case == "one live lane":
        tmax[np.arange(B) != 100] = -1.0
    else:
        tmax[:] = np.abs(tmax) + 0.5
    want = np.asarray(jsoa.bvh_any(big_scene(jbuilder, dtype=jnp.float32), _jvec(o), _jvec(d),
                                   T_MIN, jnp.asarray(tmax)))
    ts = big_scene(tbuilder, device="cpu")
    n, k = tw.any_bvh_plain.calls, tw.any_bvh.launches
    hit, counters = tw.any_bvh(ts, _tvec(o), _tvec(d), torch.from_numpy(tmax))
    assert tw.any_bvh_plain.calls == n + 1 and tw.any_bvh.launches == k
    np.testing.assert_array_equal(hit.numpy(), want)
    live = tmax > 0.0
    assert not hit.numpy()[~live].any()
    if live.any():
        _, c_live = tsoa.bvh_any(ts, _tvec(o[live]), _tvec(d[live]), T_MIN,
                                 torch.from_numpy(tmax[live]))
        assert counters.tolist() == c_live.tolist() and counters[0] > 0
    else:
        assert counters.tolist() == [0, 0, 0, 0]


def test_any_hit_takes_the_bvh(monkeypatch):
    """soa.any_hit on a use_bvh scene walks the BVH (the wrapper's plain
    version on a CPU tensor), masks lanes as bpt_tpu's any_hit does, and
    never sweeps every triangle."""
    o, d, tmax = _shadow_lanes(300, 5, np.float32)
    mask = np.arange(300) % 5 != 0
    want = np.asarray(jsoa.any_hit(big_scene(jbuilder, dtype=jnp.float32), _jvec(o), _jvec(d),
                                   T_MIN, jnp.asarray(tmax), mask=jnp.asarray(mask)))
    ts = big_scene(tbuilder, device="cpu")
    monkeypatch.setattr(tsoa, "brute_any", None)  # a sweep would raise
    n = tsoa.bvh_any.calls
    got = tsoa.any_hit(ts, _tvec(o), _tvec(d), T_MIN, torch.from_numpy(tmax),
                       mask=torch.from_numpy(mask))
    assert tsoa.bvh_any.calls == n + 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[~mask].any()
    n = tw.any_bvh_plain.calls
    hit, counters = tw.any_bvh(ts, _tvec(o), _tvec(d), torch.from_numpy(np.where(mask, tmax, 0)))
    assert tw.any_bvh_plain.calls == n + 1
    np.testing.assert_array_equal(hit.numpy(), want)
    assert counters.dtype == torch.int64 and counters.shape == (4,)


W_BIG, SPP_BIG, DEPTH_BIG = 6, 4, 3


def _cfg(cls, integrator, **kw):
    """6x6, 4 spp, depth 3 on the big scene; bdpt-mis with a defocus disk."""
    defocus = 2.0 if integrator == "bdpt-mis" else 0.0
    return cls(image_width=W_BIG, aspect_ratio=1.0, samples_per_pixel=SPP_BIG,
               max_depth=DEPTH_BIG, vfov=40.0, lookfrom=(0.0, 2.0, 6.0),
               lookat=(0.0, 1.0, 0.0), focus_dist=6.0, defocus_angle=defocus,
               integrator=integrator, **kw)


@pytest.fixture(scope="module")
def port_scene():
    return big_scene(tbuilder, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_renders():
    """bpt_tpu's CPU renders (the jnp stratum loop) at f64, with their
    stratum checkpoints."""
    js = big_scene(jbuilder, dtype=jnp.float64)
    out = {}
    for integrator in ("bdpt", "bdpt-mis"):
        snaps = []
        res = jrender(js, _cfg(JCameraConfig, integrator), seed=5,
                      stratum_callback=snaps.append)
        out[integrator] = (res, snaps)
    return out


@pytest.fixture(scope="module")
def port_renders(port_scene):
    return {i: render(port_scene, _cfg(CameraConfig, i), seed=5)
            for i in ("bdpt", "bdpt-mis")}


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_render_matches_bpt_tpu(jax_renders, port_renders, integrator):
    want = jax_renders[integrator][0]
    got = port_renders[integrator]
    np.testing.assert_allclose(got.framebuffer_sum, want.framebuffer_sum, rtol=0, atol=1e-10)
    assert float(want.framebuffer_sum.mean()) > 0.1
    assert [getattr(got.stats, k) for k in STATS] == [getattr(want.stats, k) for k in STATS]
    assert got.stats.rays_traced > W_BIG * W_BIG * SPP_BIG
    assert got.stats.shadow_rays > 0
    if integrator == "bdpt-mis":
        assert got.stats.shadow_rays == want.stats.shadow_rays
    assert got.stats.bvh_nodes_built == want.stats.bvh_nodes_built


def test_bdpt_shadow_counts_differ_only_on_coplanar_pairs(monkeypatch):
    """bdpt_fast on both sides with every shadow wave recorded: the pairs
    that reach the any-hit test differ only where the connection runs
    within 1e-12 of the floor's plane, and every pair both sides test
    gets the same answer."""
    js = big_scene(jbuilder, dtype=jnp.float64)
    ts = big_scene(tbuilder, device="cpu", dtype=torch.float64)
    g = np.random.default_rng(0)
    B = 144
    o = np.tile([[0.0, 2.0, 6.0]], (B, 1))
    d = np.c_[g.uniform(-2, 2, B), g.uniform(0, 3, B), np.zeros(B)] - o
    ids = np.arange(B, dtype=np.int32)
    waves = {"j": [], "t": []}
    j_any, t_any = jsoa.any_hit, tsoa.any_hit

    def j_rec(scene, o_, d_, tmin, tmax, mask=None):
        r = j_any(scene, o_, d_, tmin, tmax, mask)
        waves["j"].append((np.asarray(d_.y), np.asarray(mask), np.asarray(r)))
        return r

    def t_rec(scene, o_, d_, tmin, tmax, mask=None, plain=False):
        r = t_any(scene, o_, d_, tmin, tmax, mask, plain)
        waves["t"].append((d_.y.numpy(), mask.numpy(), r.numpy()))
        return r

    monkeypatch.setattr(jsoa, "any_hit", j_rec)
    monkeypatch.setattr(tsoa, "any_hit", t_rec)
    jrad, jst = jbdpt.bdpt_fast(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ids),
                                jax.random.PRNGKey(5), DEPTH_BIG)
    trad, tst = tbdpt.bdpt_fast(ts, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(ids), rng.prng_key(5), DEPTH_BIG)
    np.testing.assert_allclose(trad.numpy(), np.asarray(jrad), rtol=0, atol=1e-10)
    assert len(waves["j"]) == len(waves["t"]) == DEPTH_BIG
    n_diff = 0
    for (jdy, jm, jr), (tdy, tm, tr) in zip(waves["j"], waves["t"]):
        differ = jm != tm
        n_diff += int(differ.sum())
        assert (np.abs(jdy[differ]) < 1e-12).all() and (np.abs(tdy[differ]) < 1e-12).all()
        both = jm & tm
        np.testing.assert_array_equal(jr[both], tr[both])
    assert abs(int(jst.shadow_rays) - int(tst.shadow_rays)) <= n_diff


def test_bdpt_wave_splits_change_no_bit(port_scene, port_renders, monkeypatch):
    """One stratum a wave, and one stratum in pixel ranges of 10, give the
    image and the counters of the four-strata wave bit for bit."""
    npix = W_BIG * W_BIG
    assert trender_mod._bdpt_wave_shape(npix, SPP_BIG, DEPTH_BIG, True) == (SPP_BIG, npix)
    assert trender_mod._bdpt_wave_shape(512 * 512, 4, 10, True) == (4, 512 * 512)
    strata, span = trender_mod._bdpt_wave_shape(512 * 512, 4, 80, True)
    assert strata == 1 and span < 512 * 512
    a, b, c = trender_mod.BYTES_PER_RAY[torch.float64][True]  # the port's scene is float64
    per_ray = a * DEPTH_BIG ** 2 + b * DEPTH_BIG + c
    for budget, shape in ((npix * per_ray, (1, npix)), (10 * per_ray, (1, 10))):
        monkeypatch.setattr(trender_mod, "BDPT_WAVE_BYTES", budget)
        assert trender_mod._bdpt_wave_shape(npix, SPP_BIG, DEPTH_BIG, True,
                                            torch.float64) == shape
        snaps = []
        got = render(port_scene, _cfg(CameraConfig, "bdpt-mis"), seed=5,
                     stratum_callback=snaps.append)
        want = port_renders["bdpt-mis"]
        np.testing.assert_array_equal(got.framebuffer_sum, want.framebuffer_sum)
        assert [getattr(got.stats, k) for k in ("shadow_rays", *STATS)] == [
            getattr(want.stats, k) for k in ("shadow_rays", *STATS)]
        assert [s["strata_done"] for s in snaps] == [1, 2, 3, 4]
        assert {(s["unit_kind"], s["stream"]) for s in snaps} == {("stratum", "jnp")}


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_resumes_bpt_tpu_stratum_checkpoint(port_scene, jax_renders, integrator):
    """A stratum checkpoint that bpt_tpu's jnp loop wrote after 2 of 4
    strata resumes in the port to bpt_tpu's full image; a checkpoint of
    the pt_wave stream is refused."""
    want, snaps = jax_renders[integrator]
    snap = snaps[1]
    assert snap["strata_done"] == 2 and snap["stream"] == "jnp"
    got = render(port_scene, _cfg(CameraConfig, integrator), seed=5, resume=snap)
    np.testing.assert_allclose(got.framebuffer_sum, want.framebuffer_sum, rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="jnp stream"):
        render(port_scene, _cfg(CameraConfig, integrator), seed=5,
               resume=dict(snap, stream="wave"))


def test_cli_renders_the_coffee_yaml_with_its_bdpt_default(tmp_path):
    """The coffee stand-in's YAML (91,540 triangles; integrator bdpt) at
    8x8, 1 spp, depth 2 through the CLI, without --integrator and without
    importing JAX: the fused route's walk mode traces subpaths and shadow
    rays."""
    import os
    import re
    import subprocess
    import sys

    from bpt_tpu_torch.utils.png import read_png

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\nfrom bpt_tpu_torch.render import main\nrc = main(sys.argv[1:])\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'bpt_tpu')]\n"
            "sys.exit(rc)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, os.path.join(root, "scenes", "coffee", "coffee_standin.yaml"),
         "--device", "cpu", "--size", "8x8", "--spp", "1", "--max-depth", "2",
         "--output", "c.png", "--output-dir", str(tmp_path), "--no-progress"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    stats = {k: int(v) for k, v in re.findall(r"(rays traced|shadow rays):\s+(\d+)", proc.stderr)}
    assert stats["rays traced"] >= 64 and stats["shadow rays"] > 0
    assert read_png(str(tmp_path / "c.png")).any()
