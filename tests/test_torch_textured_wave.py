"""``pt_wave``'s textured mode on bpt_tpu_torch (plain versions) against
bpt_tpu, the hit point every live hit leaves, the texel stage, and the
routes of textured scenes.

Tolerances: textured ``pt_wave_plain`` against bpt_tpu's jnp wavefront on
the kernels' stream to rtol 1e-4 / atol 1e-5 with rays exact, as
``tests/test_pallas_kernels.py`` holds bpt_tpu's own textured pt_wave: the
wave shades with albedo 1 and multiplies the texel in after the bounce,
which rounds otherwise than the estimator's ``thr * albedo * w``.  The
textured lights lie off their checker's cell boundaries (y = 6.03): a hit
point on one takes its parity from the last bit of t."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import pt as jpt
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import textures as jtex
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.models.render import _route, render
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.kernels import intersect as ki
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import textures as ttex
from bpt_tpu_torch.scene.types import MAT_LIGHT, CameraConfig
from torch_parity import textured_wave_scene


@pytest.mark.parametrize("light", [False, True], ids=["surfaces", "light"])
@pytest.mark.parametrize("big", [False, True], ids=["brute", "bvh"])
def test_pt_wave_plain_textured_matches_bpt_tpu(big, light):
    """bpt_tpu's test_pt_wave_textured_matches_jnp and
    test_pt_wave_textured_light_matches_jnp on the port: textured pt_wave
    (plain versions: closest_tri's on the brute scene, closest_bvh's on the
    BVH one, the shade with albedo 1 and the texel stage) against bpt_tpu's
    jnp wavefront fed the kernels' stream."""
    js = textured_wave_scene(jbuilder, jtex, big, light, dtype=jnp.float32)
    ts = textured_wave_scene(tbuilder, ttex, big, light, device="cpu")
    assert ts.use_bvh == big and not tk.shade_reject_reason(ts)
    assert tk.megakernel_reject_reason(ts)
    B, depth = 192, 4
    g = np.random.default_rng(61 + 2 * int(light) + int(big))
    o = np.tile([[0.0, 2.0, 6.0]], (B, 1)).astype(np.float32)
    tgt = np.concatenate([g.uniform(-2, 2, (B, 1)), g.uniform(0, 6 if light else 3, (B, 1)),
                          np.zeros((B, 1))], 1)
    d = (tgt - np.array([0.0, 2.0, 6.0])).astype(np.float32)
    ids = np.arange(B, dtype=np.int32)
    seed = 23 if light else 19
    rad_ref, st_ref = jpt.path_trace_radiance(
        js, jnp.asarray(o), jnp.asarray(d), depth,
        jpt.kernel_stream_uniforms_fn(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.float32))
    want = np.asarray(rad_ref)
    assert want.max() > 0
    calls = (tw.closest_bvh_plain.calls, ki.closest_tri_plain.calls)
    rx, ry, rz, rays_, extra = tw.pt_wave_plain(
        ts, Vec3(*torch.from_numpy(o).unbind(1)), Vec3(*torch.from_numpy(d).unbind(1)),
        torch.from_numpy(ids), rng.prng_key(seed), depth)
    if big:
        assert tw.closest_bvh_plain.calls == calls[0] + depth
    else:
        assert ki.closest_tri_plain.calls == calls[1] + depth
    got = torch.stack([rx, ry, rz], -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert int(rays_) == int(st_ref.rays_traced)
    assert extra[2] > 0 and extra[3] > 0


def test_pt_bounce_writes_the_hit_point_of_every_live_hit():
    """A lane that ends on an emitter (or at a mixture pdf of 0) leaves the
    hit point in its origin, for the texel stage; a miss keeps its origin."""
    ts = textured_wave_scene(tbuilder, ttex, False, True, device="cpu")
    B = 256
    g = np.random.default_rng(7)
    o = torch.from_numpy(np.tile([[0.0, 2.0, 6.0]], (B, 1)).astype(np.float32))
    tgt = np.concatenate([g.uniform(-3, 3, (B, 1)), g.uniform(0, 9, (B, 1)),
                          np.zeros((B, 1))], 1)
    d = torch.from_numpy((tgt - [0.0, 2.0, 6.0]).astype(np.float32))
    ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
    alive = torch.ones(B, dtype=torch.bool)
    h = tsoa.closest_hit(ts, ov, dv, 1e-3, torch.inf)
    thr = Vec3(*torch.ones(3, B))
    U = tpt.kernel_stream_uniforms_fn(rng.prng_key(1), torch.arange(B), torch.float32)
    o2, _, _, inc, alive_new = tpt.pt_bounce(ts, ov, dv, thr, alive, h, U(0, tpt.NU))
    on_light = h.hit & (ts.materials.mtype[ts.mat_id[h.tri]] == MAT_LIGHT)
    assert on_light.sum() > 5 and not alive_new[on_light].any()
    rec = tsoa.complete_hit(ts, ov, dv, h)
    for got, p, o0 in zip(o2, rec.p, ov):
        assert torch.equal(got[h.hit], p[h.hit]) and torch.equal(got[~h.hit], o0[~h.hit])


def test_texel_stage_scales_lights_and_throughput_only_where_textured():
    """The stage leaves untextured and dielectric lanes, and lanes that were
    dead, alone; multiplies the live textured lanes' throughput; scales the
    textured light lanes' radiance."""
    ts = textured_wave_scene(tbuilder, ttex, False, True, device="cpu")
    T = ts.num_tris
    tri = torch.arange(-1, T, dtype=torch.int32)
    B = tri.shape[0]
    state = torch.rand((tw.STATE_ROWS, B), generator=torch.Generator().manual_seed(0))
    state[tw.ALIVE] = (torch.arange(B) % 2).float()
    before = state.clone()
    u, v = torch.full((B,), 0.25), torch.full((B,), 0.5)
    tw.texel_stage(ts, state, tri, u, v)
    mat = ts.mat_id[tri.clamp_min(0).long()]
    textured = (tri >= 0) & (ts.materials.tex_id[mat] >= 0)
    light = ts.materials.mtype[mat] == MAT_LIGHT
    thr_moved = (state[tw.THR] != before[tw.THR])
    rad_moved = (state[tw.RAD] != before[tw.RAD])
    assert not thr_moved[~textured | (state[tw.ALIVE] < 0.5)].any()
    assert thr_moved[textured & ~light & (state[tw.ALIVE] > 0.5)].any()
    assert not rad_moved[~(textured & light)].any() and rad_moved[textured & light].any()
    assert torch.equal(state[:tw.THR], before[:tw.THR])


# ----------------------------------------------------------------- routes


def _cfg(width, integrator, **kw):
    return CameraConfig(image_width=width, aspect_ratio=1.0, samples_per_pixel=4,
                        max_depth=4, integrator=integrator, **kw)


@pytest.mark.parametrize("big", [False, True], ids=["small", "large"])
def test_routes_of_textured_scenes(big):
    """Textured PT at 2^18 pixels or more takes pt_wave at any triangle
    count, below it the stratum loop; textured BDPT takes the stratum loop,
    or on a large scene at 2^18 samples or more the BDPT wave loop, which is
    the stratum loop over bpt_tpu's jnp estimator; the fused route never."""
    ts = textured_wave_scene(tbuilder, ttex, big, True, device="cpu")
    assert ts.num_tris > tk.MAX_TRIS if big else ts.num_tris <= tk.MAX_TRIS
    assert "textures" in tk.megakernel_reject_reason(ts)
    assert _route(ts, _cfg(512, "pt"), "pt", None) == "wave"
    assert _route(ts, _cfg(511, "pt"), "pt", None) == "strata"
    assert _route(ts, _cfg(512, "pt", ref_vis=True), "pt", None) == "strata"
    for integrator in ("bdpt", "bdpt-mis"):
        assert _route(ts, _cfg(64, integrator), integrator, None) == "strata"
        assert _route(ts, _cfg(256, integrator), integrator, None) == (
            "bdpt_wave" if big else "strata")
    f64 = textured_wave_scene(tbuilder, ttex, big, True, device="cpu", dtype=torch.float64)
    assert _route(f64, _cfg(512, "pt"), "pt", None) == "strata"


def test_render_textured_pt_through_the_wave_equals_the_plain_wave(monkeypatch):
    """render() of a textured brute scene through the wave route equals
    pt_wave_plain on the render's rays, bit for bit."""
    from bpt_tpu_torch.models import render as rmod

    ts = textured_wave_scene(tbuilder, ttex, False, True, device="cpu")
    cfg = _cfg(6, "pt", vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    monkeypatch.setattr(rmod, "WAVE_MIN_RAYS", 36)
    assert _route(ts, cfg, "pt", None) == "wave"
    n = tw.pt_wave_bounce_plain.calls
    res = render(ts, cfg, seed=2)
    assert tw.pt_wave_bounce_plain.calls == n + cfg.max_depth
    monkeypatch.setattr(rmod, "pt_wave", tw.pt_wave_plain)
    again = render(ts, cfg, seed=2)
    np.testing.assert_array_equal(res.framebuffer_sum, again.framebuffer_sum)
    assert res.framebuffer_sum.sum() > 0
