"""Float64 on scenes with a BVH: the float64 walk tables, the hit dispatch
that sends every float64 interval to the BVH walk kernels ``closest_bvh`` /
``any_bvh`` (as ``bpt_tpu`` walks the BVH in jnp for every float64 hit),
the split rejection reasons, and the plain walk and a PT render at float64
against ``bpt_tpu`` on the CPU.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``); here every wrapper takes its plain
version, because the lanes lie on the CPU.  A card scene's dispatch is
forced by patching ``soa._card_bvh``, as tests/test_torch_cluster_wave.py
does.  Tolerances: hits, triangle ids and the four walk counters exact; t,
u, v to 1e-12 (XLA's CPU backend contracts a*b+c in Möller–Trumbore, torch
does not); the render to 1e-10 with its counters exact."""

import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.models.render import render as jrender
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene.types import CameraConfig as JCameraConfig
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import cluster_wave as cw
from bpt_tpu_torch.ops.kernels import plucker as kp
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_rays, big_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("node_visits", "aabb_hits", "tri_tests", "tri_hits")
STATS = ("rays_traced", "shadow_rays", "bvh_node_visits", "aabb_hits", "triangle_tests",
         "triangle_hits")


@pytest.fixture(scope="module")
def scene64():
    return big_scene(tbuilder, device="cpu", dtype=torch.float64)


def _tvec(a):
    return Vec3(*torch.from_numpy(np.ascontiguousarray(a)).unbind(1))


def _jvec(a):
    return jv3.from_array(jnp.asarray(a))


def _interval_lanes(B, seed):
    """big_rays at f64 with per-lane intervals: half the lanes from T_MIN,
    the rest from a tmin in [-1, 1); half to inf, the rest to a tmax in [0,
    6); a few NaN bounds, tmax 0 and tmax -1; one lane in eight masked."""
    o, d = (x.astype(np.float64) for x in big_rays(B, seed))
    g = np.random.default_rng(seed)
    tmin = np.where(g.uniform(size=B) < 0.5, T_MIN, g.uniform(-1.0, 1.0, B))
    tmax = np.where(g.uniform(size=B) < 0.5, np.inf, g.uniform(0.0, 6.0, B))
    tmin[::89] = np.nan
    tmax[::97] = np.nan
    tmax[::53] = 0.0
    tmax[::61] = -1.0
    mask = g.uniform(size=B) > 0.125
    return o, d, tmin, tmax, mask


# ---------------------------------------------------------------- tables


def test_float64_walk_tables_unpack_to_the_scene_and_are_packed_once(scene64):
    """nodes [N, 8] f64, one 64-byte record a node (min x, max x, min y,
    max y, min z, max z, then skip and first*4 + count as two int32, and a
    zero pad), tris [T, 10] f64, one 80-byte row a triangle (v0, e1, e2, a
    zero pad): equal to the scene's arrays bit for bit, packed at the first
    call and kept with the scene."""
    nodes, tris = tw.walk_tables64(scene64)
    assert nodes.dtype == tris.dtype == torch.float64
    assert nodes.shape == (scene64.bvh_min.shape[0], 8) and tris.shape == (scene64.num_tris, 10)
    assert nodes.is_contiguous() and tris.is_contiguous()
    assert torch.equal(nodes[:, 0:6:2], scene64.bvh_min)
    assert torch.equal(nodes[:, 1:6:2], scene64.bvh_max)
    links = nodes.view(torch.int32)[:, 12:14].long()
    assert torch.equal(links[:, 0], scene64.bvh_skip.long())
    assert torch.equal(links[:, 1] >> 2, scene64.bvh_first.long())
    assert torch.equal(links[:, 1] & 3, scene64.bvh_count.long())
    assert not bool(nodes[:, 7].any()) and not bool(tris[:, 9].any())
    assert torch.equal(tris[:, :9], torch.cat([scene64.v0, scene64.e1, scene64.e2], dim=1))
    again = tw.walk_tables64(scene64)
    assert all(a is b for a, b in zip(again, (nodes, tris)))
    assert id(scene64) in tw.walk_tables64.cache
    assert tw.bounds_ok(scene64)


# -------------------------------------------------------------- dispatch


F64_CASES = {
    "production": ("closest", T_MIN, torch.inf, {}),
    "per-lane tmax": ("any", T_MIN, "lanes", {}),
    "tmin != T_MIN": ("closest", 0.0, torch.inf, {}),
    "any tmin != T_MIN": ("any", "lanes", "lanes", {}),
    "BPT_TPU_NO_FTB=1": ("closest", T_MIN, torch.inf, {"BPT_TPU_NO_FTB": "1"}),
    "BPT_TPU_WAVE_IMPL=plucker": ("any", T_MIN, "lanes", {"BPT_TPU_WAVE_IMPL": "plucker"}),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_float64_dispatch_takes_the_walk_kernels(case, scene64, monkeypatch):
    """A float64 card scene with a BVH takes closest_bvh / any_bvh for every
    interval and under every switch: no clustered kernel, no Morton sort.
    Forced onto the card dispatch on a CPU scene, the wrappers then run
    their plain versions, whose answers and counters equal the CPU walk's."""
    which, tmin, tmax, env = F64_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    B = 300
    o, d, tmin_l, tmax_l, mask = _interval_lanes(B, 5)
    tmin = torch.from_numpy(tmin_l) if tmin == "lanes" else tmin
    tmax = torch.from_numpy(np.nan_to_num(tmax_l, nan=2.0)) if tmax == "lanes" else tmax
    assert tsoa.wave_impl(tmin, tmax if which == "closest" else None, torch.float64) == "bvh64"
    mask_t = torch.from_numpy(mask)
    args = (_tvec(o), _tvec(d), tmin, tmax)
    fn = {"closest": tsoa.closest_hit, "any": tsoa.any_hit_counted}[which]
    want = fn(scene64, *args, mask=mask_t)  # a CPU scene walks in torch
    plains = (cw.clustered_closest_plain, cw.clustered_any_plain, kp.plucker_closest_plain,
              kp.plucker_any_plain)
    calls = [p.calls for p in plains]
    wrapper = {"closest": tw.closest_bvh_plain, "any": tw.any_bvh_plain}[which]
    n = wrapper.calls
    monkeypatch.setattr(tsoa, "_card_bvh", lambda scene: scene.use_bvh)
    got = fn(scene64, *args, mask=mask_t)
    assert wrapper.calls == n + 1
    assert [p.calls for p in plains] == calls
    if which == "closest":
        for f in ("hit", "tri", "t", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert [int(getattr(got, c)) for c in COUNTERS] == [int(getattr(want, c))
                                                           for c in COUNTERS]
        assert bool(got.hit.any())
    else:
        assert torch.equal(got[0], want[0]) and got[1].tolist() == want[1].tolist()
    # plain=True walks the BVH in torch as well
    n = wrapper.calls
    fn(scene64, *args, mask=mask_t, plain=True)
    assert wrapper.calls == n


@pytest.mark.parametrize("tmin, tmax, env, impl", [
    (T_MIN, torch.inf, {}, "bvh"),
    (T_MIN, None, {}, "bvh"),
    (0.0, torch.inf, {}, "roll"),
    (T_MIN, torch.zeros(3), {}, "roll"),
    (T_MIN, torch.inf, {"BPT_TPU_NO_FTB": "1"}, "roll"),
    (T_MIN, None, {"BPT_TPU_WAVE_IMPL": "plucker"}, "plucker"),
], ids=["closest", "any", "tmin", "tmax-lanes", "no-ftb", "plucker"])
def test_float32_dispatch_is_unchanged(tmin, tmax, env, impl, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tsoa.wave_impl(tmin, tmax) == impl
    assert tsoa.wave_impl(tmin, tmax, torch.float32) == impl
    assert tsoa.wave_impl(tmin, tmax, torch.float64) == "bvh64"


def test_walk_launch_arguments(scene64):
    """What a float64 launch is handed: the rays in float64 and tmin, tmax
    as [B] float64 tensors (a number broadcast); float32 takes the
    production interval only."""
    o, d, tmin, _, mask = _interval_lanes(64, 9)
    active = torch.from_numpy(mask)
    dev, B, ins, bounds = tw._walk_args("closest_bvh", scene64, _tvec(o), _tvec(d), active,
                                        torch.from_numpy(tmin), torch.inf)
    assert B == 64 and all(x.dtype == torch.float64 and x.shape == (64,) for x in ins)
    np.testing.assert_array_equal(bounds[0].numpy(), tmin)
    assert bool(bounds[1].isinf().all())
    assert len(tw._walk_args("any_bvh", scene64, _tvec(o), _tvec(d), active, T_MIN,
                             None)[3]) == 1
    f32 = big_scene(tbuilder, device="cpu")
    o32, d32 = (_tvec(x.astype(np.float32)) for x in (o, d))
    assert tw._walk_args("closest_bvh", f32, o32, d32, active, T_MIN, torch.inf)[3] is None
    with pytest.raises(ValueError, match="interval"):
        tw._walk_args("closest_bvh", f32, o32, d32, active, 0.0, torch.inf)
    with pytest.raises(ValueError, match="expected torch.float64"):
        tw._walk_args("closest_bvh", scene64, o32, d32, active, T_MIN, torch.inf)


# ------------------------------------------------------ rejection reasons


def test_rejection_reasons_split_by_kernel(scene64):
    """The walk kernels take float64; pt_wave's shade, the clustered
    kernels and the megakernels refuse it, each naming the route float64
    takes."""
    assert tw.walk_reject_reason(scene64) == ""
    for reason in (pk.shade_reject_reason(scene64), cw.cluster_reject_reason(scene64),
                   pk.megakernel_reject_reason(scene64, "pt"),
                   pk.megakernel_reject_reason(scene64, "bdpt")):
        assert "float64" in reason and "stratum loop" in reason, reason
        assert "ROADMAP" not in reason
    f32 = big_scene(tbuilder, device="cpu")
    assert tw.walk_reject_reason(f32) == cw.cluster_reject_reason(f32) == ""
    assert "float16" in tw.walk_reject_reason(types.SimpleNamespace(dtype=torch.float16))


def test_render_takes_float64_bvh_scenes_on_the_stratum_route(scene64):
    cfg = _cfg(CameraConfig, "pt")
    for integrator in ("pt", "bdpt", "bdpt-mis"):
        assert trender._route(scene64, cfg, integrator, None) == "strata"
        assert trender._reject_reason(scene64, cfg, integrator, "strata") == ""


# ------------------------------------------------------ against bpt_tpu


def test_plain_closest_walk_matches_bpt_tpu_at_f64(scene64):
    """closest_bvh (its plain version on the CPU) over per-lane [tmin, tmax]
    with a mask against bpt_tpu's closest_hit, which walks the BVH in jnp
    (bvh_closest) at float64 on any backend."""
    o, d, tmin, tmax, mask = _interval_lanes(600, 3)
    js = big_scene(jbuilder, dtype=jnp.float64)
    want = jsoa.closest_hit(js, _jvec(o), _jvec(d), jnp.asarray(tmin), jnp.asarray(tmax),
                            mask=jnp.asarray(mask))
    t, tri, u, v, c = tw.closest_bvh(scene64, _tvec(o), _tvec(d), torch.from_numpy(mask),
                                     torch.from_numpy(tmin), torch.from_numpy(tmax))
    hit = np.asarray(want.hit)
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(tri.numpy(), np.where(hit, np.asarray(want.tri), -1))
    assert c.tolist() == [int(getattr(want, k)) for k in COUNTERS]
    for got, ref in ((t, want.t), (u, want.u), (v, want.v)):
        np.testing.assert_allclose(got.numpy()[hit], np.asarray(ref)[hit], rtol=1e-12,
                                   atol=1e-12)
    assert np.isinf(t.numpy()[~hit]).all()


def test_plain_any_walk_matches_bpt_tpu_at_f64(scene64):
    """any_bvh (its plain version) over per-lane [tmin, tmax], masked lanes
    dead with tmax 0, against bpt_tpu's bvh_any (which returns no
    counters; the port's are held against the kernel on the card).  A lane
    with tmax <= 0 is dead in the port and misses; bpt_tpu's bvh_any walks
    it, and over a tmin below 0 can find a hit behind the origin (ROADMAP
    §3): the lanes may differ there only, the port's answer a miss."""
    o, d, tmin, tmax, mask = _interval_lanes(600, 4)
    tmax = np.where(mask, tmax, 0.0)
    js = big_scene(jbuilder, dtype=jnp.float64)
    want = np.asarray(jsoa.bvh_any(js, _jvec(o), _jvec(d), jnp.asarray(tmin),
                                   jnp.asarray(tmax)))
    hit, c = tw.any_bvh(scene64, _tvec(o), _tvec(d), torch.from_numpy(tmax),
                        torch.from_numpy(tmin))
    assert 0.1 < want.mean() < 0.9
    behind = (tmax <= 0) & (tmin < 0)
    np.testing.assert_array_equal(hit.numpy()[~behind], want[~behind])
    assert not hit.numpy()[tmax <= 0].any()
    assert 0 < behind.sum() < 100
    assert c.dtype == torch.int64 and int(c[0]) > int(mask.sum())


W_BIG, SPP_BIG, DEPTH_BIG = 6, 4, 3


def _cfg(cls, integrator):
    return cls(image_width=W_BIG, aspect_ratio=1.0, samples_per_pixel=SPP_BIG,
               max_depth=DEPTH_BIG, vfov=40.0, lookfrom=(0.0, 2.0, 6.0),
               lookat=(0.0, 1.0, 0.0), focus_dist=6.0, integrator=integrator)


def test_pt_render_matches_bpt_tpu_at_f64(scene64):
    """A float64 PT render of the 964-triangle scene through the stratum
    loop (its hits from the BVH walk) against bpt_tpu's jnp stratum loop."""
    want = jrender(big_scene(jbuilder, dtype=jnp.float64), _cfg(JCameraConfig, "pt"), seed=5)
    got = trender.render(scene64, _cfg(CameraConfig, "pt"), seed=5)
    np.testing.assert_allclose(got.framebuffer_sum, want.framebuffer_sum, rtol=0, atol=1e-10)
    assert float(want.framebuffer_sum.mean()) > 0.1
    assert [getattr(got.stats, k) for k in STATS] == [getattr(want.stats, k) for k in STATS]
    assert got.stats.bvh_node_visits > 0


def test_cli_f64_renders_the_glass_stand_in_on_cpu(tmp_path):
    """--f64 on a YAML scene with a BVH (the glass stand-in's 510
    triangles) exits 0 and writes its image, without JAX."""
    code = ("import sys\nfrom bpt_tpu_torch.render import main\nrc = main(sys.argv[1:])\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'bpt_tpu')]\n"
            "sys.exit(rc)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, os.path.join(ROOT, "scenes", "glass", "glass_standin.yaml"),
         "--f64", "--device", "cpu", "--size", "8x6", "--spp", "1", "--max-depth", "3",
         "--integrator", "pt", "--output", "g.png", "--output-dir", str(tmp_path),
         "--no-progress"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "g.png").exists()
