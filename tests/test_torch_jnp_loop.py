"""bpt_tpu_torch's stratum loop on small scenes against bpt_tpu on a CPU:
the brute-force hits (``ops/kernels/intersect.py``'s plain versions)
against bpt_tpu's Pallas ``closest_pallas`` / ``any_pallas`` in interpret
mode, BDPT's ``ref_vis``, and ``render()``'s route for defocus, ref_vis,
float64 and scenes over the megakernels' capacity (``models.render.
_render_strata`` over ``models.pt.path_trace_pixels_fast`` and
``models.bdpt.bdpt_fast``) against ``bpt_tpu``'s CPU route for them, the
jnp stratum loop; its waves, its checkpoints, the cornell goldens of
``tests/test_golden.py`` and the CLI's ``--f64``.

Tolerances: hits exact, t, u, v within 1e-5 relative at f32 (XLA's CPU
backend contracts a*b+c in Möller–Trumbore; PyTorch does not), triangles
exact but where a ray meets two surfaces at one t (1 lane of 3,001: an ulp
of t picks the triangle).
Renders at f64 to 1e-12 with every counter equal.  Under ref_vis a shadow
ray ends exactly at its endpoint's surface and the rounding of t decides
the pair, so the two sides differ there by design (ROADMAP §3):
- the pairs that reach the any-hit test are equal except pairs lying in
  an axis-aligned wall's plane (a direction component below 1e-12 on one
  side, 0 on the other: XLA contracts the hit point o + t*d), which carry
  no radiance;
- the tie band, measured on the 2,304 camera rays of
  ``test_ref_vis_bdpt_radiance_within_the_tie_band`` (depth 3, f64,
  bpt_tpu's estimator jitted as its render step runs it): 1.8% of the
  pairs are tested on one side only, all coplanar (3% allowed); the
  answers of the pairs both sides test differ on 8.3% of them (12%
  allowed), the port's visible pairs among them are 3.5% fewer (6%
  allowed) and its mean radiance 0.9% higher (3% allowed); the 66% of
  lanes that no differing pair touches are equal to 1e-12 (50% required).
  On the 8x8 / 4 spp / depth 2 render the shadow rays differ by -14.4%
  and the image's mean by -2.9%: 20% and 8% are allowed.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.models import bdpt as jbdpt
from bpt_tpu.models.camera import camera_constants as jcamera_constants
from bpt_tpu.models.camera import generate_rays as jgenerate_rays
from bpt_tpu.models.render import _raygen_jitter_host
from bpt_tpu.models.render import render as jrender
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.ops.pallas import intersect as jint
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import presets as jpresets
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.kernels import intersect as ki
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.utils.png import read_png
from torch_parity import endpoint_ties, rays, shadow_wave

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("rays_traced", "shadow_rays", "bvh_node_visits", "aabb_hits", "triangle_tests",
         "triangle_hits")
W, SPP, DEPTH, SEED = 8, 4, 2, 3
DEFOCUS = dict(defocus_angle=1.0, focus_dist=1078.0)  # the focus plane at the room's centre


def _vec(a, mod):
    return (Vec3(*torch.from_numpy(a).unbind(1)) if mod is torch
            else jv3.from_array(jnp.asarray(a)))


def _hit_lanes(B=3001):
    """Random rays in the cornell box (B not a multiple of the Pallas
    tile's 2048) with per-lane intervals; one lane in five has tmax < tmin
    and can hit nothing, one in seven runs to inf."""
    o, d = rays(B, 11)
    g = np.random.default_rng(11)
    tmin = g.uniform(0.0, 50.0, B).astype(np.float32)
    tmax = (tmin + g.uniform(-200.0, 900.0, B)).astype(np.float32)
    tmax[::7] = np.inf
    return o, d, tmin, tmax


def _pallas_and_port_args(o, d, tmin, tmax):
    js = jpresets.cornell_box(dtype=jnp.float32)
    jargs = (jsoa._tri_flat(js), *(jnp.asarray(np.ascontiguousarray(a[:, k]))
                                   for a in (o, d) for k in range(3)),
             jnp.asarray(tmin), jnp.asarray(tmax))
    targs = (tpresets.cornell_box(device="cpu"), _vec(o, torch), _vec(d, torch),
             torch.from_numpy(tmin), torch.from_numpy(tmax))
    return jargs, targs


def _wave_lanes():
    """A shadow wave (torch_parity.shadow_wave: 6 light rows of 768 lanes,
    rows sparser with the light vertex, runs of dead lanes, masked and NaN
    lanes) with endpoint ties on the lanes where bpt_tpu's Pallas closest
    hit and the port's put the hit at the same t."""
    o, d, tmin, tmax, live = shadow_wave(6, 768, 13)
    far = np.where(live, np.inf, tmax).astype(np.float32)
    jargs, targs = _pallas_and_port_args(o, d, tmin, far)
    jt = np.asarray(jint.closest_pallas(*jargs, interpret=True)[0])
    tmax, ties = endpoint_ties(tmax, live, jt, ki.closest_tri(*targs)[0].numpy())
    rows = live.reshape(6, 768).sum(axis=1)
    assert ties.sum() >= 100 and rows[0] > 3 * rows[-1] > 0
    return o, d, tmin, tmax, ties


@pytest.mark.parametrize("which, layout", [("closest", "random"), ("any", "random"),
                                           ("closest", "shadow wave"), ("any", "shadow wave")],
                         ids=["closest", "any", "closest-shadow-wave", "any-shadow-wave"])
def test_brute_hits_match_pallas_interpret(which, layout):
    """The plain versions of closest_tri / any_tri against bpt_tpu's Pallas
    kernels in interpret mode, on random lanes and on a shadow wave's
    layout.  At a tie (tmax the hit's own t, inclusive) the port hits every
    lane; bpt_tpu's any kernel rounds t by XLA's contraction, which differs
    from its closest kernel's on a few of them, so there the two any hits
    agree on >= 97%, everywhere else exactly."""
    if layout == "random":
        o, d, tmin, tmax = _hit_lanes()
        ties = np.zeros(tmax.shape, bool)
    else:
        o, d, tmin, tmax, ties = _wave_lanes()
    jargs, targs = _pallas_and_port_args(o, d, tmin, tmax)
    if which == "closest":
        jt, jtri, ju, jv = (np.asarray(x) for x in jint.closest_pallas(*jargs, interpret=True))
        n = ki.closest_tri_plain.calls
        t, tri, u, v = (x.numpy() for x in ki.closest_tri(*targs))
        assert ki.closest_tri_plain.calls == n + 1
        hit = tri >= 0
        np.testing.assert_array_equal(hit, jtri >= 0)
        live = tmin <= tmax
        assert 0.3 < hit[live if ties.any() else ...].mean() < 0.9
        assert not np.isfinite(t[~hit]).any() and not hit[~live].any()
        np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)
        # a ray that meets two surfaces at one t (where walls or a box and
        # the floor meet) takes the lower triangle on each side, and an ulp
        # of t between the two sides' arithmetic decides which that is
        tie = tri != jtri
        assert tie.sum() <= 1e-3 * tri.size
        same = hit & ~tie
        np.testing.assert_allclose(np.c_[u, v][same], np.c_[ju, jv][same], rtol=1e-5,
                                   atol=1e-5)
        assert not np.c_[u, v][~hit].any()
        assert hit[ties].all() and (t[ties] == tmax[ties]).all()
    else:
        want = np.asarray(jint.any_pallas(*jargs, interpret=True))
        n = ki.any_tri_plain.calls
        got = ki.any_tri(*targs).numpy()
        assert ki.any_tri_plain.calls == n + 1
        np.testing.assert_array_equal(got[~ties], want[~ties])
        assert got[ties].all() and want[ties].sum() >= 0.97 * ties.sum()
        live = tmin <= tmax
        assert 0.3 < got[live if ties.any() else ...].mean() < 0.9 and not got[~live].any()


def _record(monkeypatch):
    """Records every shadow wave's (direction, mask, answer) on both sides."""
    waves = {"j": [], "t": []}
    j_any, t_any = jsoa.any_hit, tsoa.any_hit

    def j_rec(scene, o, d, tmin, tmax, mask=None):
        r = j_any(scene, o, d, tmin, tmax, mask)
        jax.debug.callback(lambda *a: waves["j"].append((np.stack(a[:3]), *a[3:])),
                           *d, mask, r, ordered=True)
        return r

    def t_rec(scene, o, d, tmin, tmax, mask=None, plain=False):
        r = t_any(scene, o, d, tmin, tmax, mask, plain)
        waves["t"].append((torch.stack(list(d)).numpy(), mask.numpy(), r.numpy()))
        return r

    monkeypatch.setattr(jsoa, "any_hit", j_rec)
    monkeypatch.setattr(tsoa, "any_hit", t_rec)
    return waves


def test_ref_vis_bdpt_radiance_within_the_tie_band(monkeypatch):
    """bdpt_radiance(ref_vis=True) at f64 on both sides with the same
    injected uniforms, for one ray through each pixel of a 48x48 cornell
    image: counters exact, pairs tested equal but for coplanar ones, and
    the tie band of the module docstring."""
    B, D = 48 * 48, 3
    cfg = dataclasses.replace(jpresets.cornell_box_camera(), image_width=48,
                              samples_per_pixel=1)
    g = np.random.default_rng(5)
    pix = np.arange(B)
    grid = [(pix % 48).astype(np.float64), (pix // 48).astype(np.float64), np.zeros(B),
            np.zeros(B), g.uniform(size=(B, 4))]
    o, d = (np.array(x) for x in jgenerate_rays(jcamera_constants(cfg, jnp.float64),
                                                  *map(jnp.asarray, grid)))
    u_cam, u_ls, u_lt = (g.uniform(size=s) for s in ((D, 5, B), (5, B), (D, 5, B)))
    waves = _record(monkeypatch)

    def run(arr, bdpt, scene, o, d, u_cam, u_ls, u_lt):
        cam = lambda b, n: [arr(u_cam[b, i]) for i in range(n)]  # noqa: E731
        light = lambda b, n: [arr(u_lt[b, i]) for i in range(n)]  # noqa: E731
        return bdpt.bdpt_radiance(scene, arr(o), arr(d), D, cam, [arr(x) for x in u_ls],
                                  light, ref_vis=True)

    # jitted, as bpt_tpu's render step runs it: XLA then contracts a*b+c
    js = jpresets.cornell_box(dtype=jnp.float64)
    jr, jst = jax.jit(lambda *a: run(jnp.asarray, jbdpt, js, *a))(o, d, u_cam, u_ls, u_lt)
    jax.effects_barrier()
    jr = np.asarray(jr)
    tr, tst = run(torch.from_numpy, tbdpt, tpresets.cornell_box(dtype=torch.float64,
                                                                 device="cpu"),
                  o, d, u_cam, u_ls, u_lt)
    tr = tr.numpy()
    for k in ("rays_traced", "tri_tests", "tri_hits"):
        assert int(getattr(tst, k)) == int(getattr(jst, k)) > 0, k
    assert len(waves["j"]) == len(waves["t"]) == D
    n = dict(tested=0, common=0, flips=0, j_vis=0, t_vis=0)
    touched = np.zeros(B, bool)
    for (jd, jm, jans), (td, tm, tans) in zip(waves["j"], waves["t"]):
        one_side = jm != tm  # coplanar pairs only
        assert (np.abs(jd).min(0)[one_side] < 1e-12).all()
        assert (np.abs(td).min(0)[one_side] < 1e-12).all()
        common = jm & tm
        flips = common & (jans != tans)
        touched |= (one_side | flips).reshape(-1, B).any(0)
        for k, v in (("tested", jm), ("common", common), ("flips", flips),
                     ("j_vis", common & ~jans), ("t_vis", common & ~tans)):
            n[k] += int(v.sum())
    assert n["common"] >= 0.97 * n["tested"] > 0
    assert n["flips"] <= 0.12 * n["common"]
    assert abs(n["t_vis"] / n["j_vis"] - 1) <= 0.06
    assert abs(tr.mean() / jr.mean() - 1) <= 0.03
    np.testing.assert_allclose(tr[~touched], jr[~touched], rtol=0, atol=1e-12)
    assert (~touched).mean() >= 0.5


def _many_materials(builder_mod, presets_mod, **kw):
    """The cornell box plus 16 small quads on the back wall, each of its
    own colour: 20 materials (over the megakernels' 16), 56 triangles, no
    BVH."""
    b = presets_mod.cornell_box_builder()
    for k in range(16):
        colour = (0.05 + 0.05 * k, 0.5, 0.9 - 0.05 * k)
        b.add_quad((30.0 + 31.0 * k, 60.0 + 20.0 * (k % 4), 554.0), (25.0, 0.0, 0.0),
                   (0.0, 25.0, 0.0), builder_mod.MaterialSpec.lambertian(colour))
    return b.build(**kw)


CONFIGS = {  # id: (integrator, camera fields, many materials)
    "ref_vis-bdpt": ("bdpt", dict(ref_vis=True), False),
    "defocus-pt": ("pt", DEFOCUS, False),
    "defocus-bdpt-mis": ("bdpt-mis", DEFOCUS, False),
    "f64-pt": ("pt", {}, False),
    "20-materials-bdpt-mis": ("bdpt-mis", {}, True),
}


def _cfg(presets_mod, integrator, **kw):
    return dataclasses.replace(presets_mod.cornell_box_camera(), image_width=W,
                               samples_per_pixel=SPP, max_depth=DEPTH,
                               integrator=integrator, **kw)


def _scene(many, mod):
    if mod is torch:
        return (_many_materials(tbuilder, tpresets, device="cpu", dtype=torch.float64)
                if many else tpresets.cornell_box(device="cpu", dtype=torch.float64))
    return (_many_materials(jbuilder, jpresets, dtype=jnp.float64) if many
            else jpresets.cornell_box(dtype=jnp.float64))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_render_matches_bpt_tpu_cpu_route(name):
    integrator, cam, many = CONFIGS[name]
    ts = _scene(many, torch)
    assert trender._route(ts, _cfg(tpresets, integrator, **cam), integrator, None) == "strata"
    if many:  # over the megakernels' capacity in float32 too
        assert int(ts.materials.mtype.shape[0]) == 20 and not ts.use_bvh
        f32 = _many_materials(tbuilder, tpresets, device="cpu")
        assert trender._route(f32, _cfg(tpresets, integrator), integrator, None) == "strata"
    want = jrender(_scene(many, jnp), _cfg(jpresets, integrator, **cam), seed=SEED)
    got = trender.render(ts, _cfg(tpresets, integrator, **cam), seed=SEED)
    assert float(want.framebuffer_sum.mean()) > 0.05
    if name == "ref_vis-bdpt":  # the tie band
        for k in STATS[:1] + STATS[2:]:
            assert getattr(got.stats, k) == getattr(want.stats, k), k
        assert abs(got.stats.shadow_rays / want.stats.shadow_rays - 1) <= 0.2
        assert abs(got.framebuffer_sum.mean() / want.framebuffer_sum.mean() - 1) <= 0.08
    else:
        np.testing.assert_allclose(got.framebuffer_sum, want.framebuffer_sum, rtol=0,
                                   atol=1e-12)
        assert [getattr(got.stats, k) for k in STATS] == [getattr(want.stats, k)
                                                          for k in STATS]


def _f64(integrator, **kw):
    return tpresets.cornell_box(device="cpu", dtype=torch.float64), _cfg(tpresets, integrator,
                                                                          **kw)


def test_loop_waves_change_no_bit(monkeypatch):
    """One stratum a wave, and pixel ranges of 10 for BDPT, give the image
    and the counters of the default waves (all four strata) bit for bit."""
    runs = {}
    for integrator, cam in (("bdpt", dict(ref_vis=True)), ("pt", DEFOCUS)):
        scene, cfg = _f64(integrator, **cam)
        whole = trender.render(scene, cfg, seed=SEED)
        with monkeypatch.context() as m:
            m.setattr(trender, "_wave_spp_batch", lambda npix, spp: 1)
            a, b, c = trender.BYTES_PER_RAY[torch.float64][False]
            m.setattr(trender, "BDPT_WAVE_BYTES", 10 * (a * DEPTH ** 2 + b * DEPTH + c))
            assert trender._bdpt_wave_shape(W * W, SPP, DEPTH, False, torch.float64) == (1, 10)
            split = trender.render(scene, cfg, seed=SEED)
        runs[integrator] = whole
        np.testing.assert_array_equal(split.framebuffer_sum, whole.framebuffer_sum)
        assert dataclasses.replace(split.stats, wall_seconds=0) == dataclasses.replace(
            whole.stats, wall_seconds=0)
    assert runs["bdpt"].stats.shadow_rays > 0 and runs["pt"].stats.rays_traced > 0


def test_jnp_checkpoint_resumes_the_small_scene_loop(monkeypatch):
    """The loop writes stratum checkpoints of the jnp stream, and resuming
    one gives the uninterrupted image bit for bit; on a float32 cornell box
    that the fused loop would render fresh, a jnp checkpoint takes the
    loop.  A chunk-kind checkpoint and one of the pt_wave stream raise,
    with bpt_tpu's words."""
    scene, cfg = _f64("bdpt", ref_vis=True)
    a, b, c = trender.BYTES_PER_RAY[torch.float64][False]
    monkeypatch.setattr(trender, "BDPT_WAVE_BYTES", W * W * (a * DEPTH ** 2 + b * DEPTH + c))
    snaps = []
    whole = trender.render(scene, cfg, seed=SEED, stratum_callback=snaps.append)
    assert [(s["strata_done"], s["unit_kind"], s["stream"]) for s in snaps] == [
        (k, "stratum", "jnp") for k in range(1, SPP + 1)]
    resumed = trender.render(scene, cfg, seed=SEED, resume=snaps[1])
    np.testing.assert_array_equal(resumed.framebuffer_sum, whole.framebuffer_sum)
    with pytest.raises(ValueError, match="chunk-kind"):
        trender.render(scene, cfg, seed=SEED, resume=dict(snaps[1], unit_kind="chunk"))
    with pytest.raises(ValueError, match="jnp stream"):
        trender.render(scene, cfg, seed=SEED, resume=dict(snaps[1], stream="wave"))

    f32, cfg = tpresets.cornell_box(device="cpu"), _cfg(tpresets, "pt")
    assert trender._route(f32, cfg, "pt", None) == "fused"
    fb, snaps = torch.zeros((W * W, 3)), []
    monkeypatch.setattr(trender, "_wave_spp_batch", lambda npix, spp: 1)
    trender._render_strata(f32, cfg, camera_constants(cfg), "pt", SEED, fb, None, None,
                           snaps.append)
    snap = snaps[-2]
    assert snap["strata_done"] == SPP - 1 and snap["stream"] == "jnp"
    assert trender._route(f32, cfg, "pt", snap) == "strata"
    got = trender.render(f32, cfg, seed=SEED, resume=snap)
    np.testing.assert_array_equal(got.framebuffer_sum, fb.numpy().reshape(W, W, 3))
    assert got.stats.rays_traced > 0


def _rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float64) / 255 - b.astype(np.float64) / 255) ** 2)))


@pytest.mark.parametrize("integrator", ["pt", "bdpt"])
def test_cornell_golden_through_the_loop(integrator):
    """tools/gen_goldens.py's cornell configs (64x64, 16 spp, depth 5, seed
    1234, float32), rendered by bpt_tpu's jnp stratum loop on a CPU,
    reproduced by the port's loop on a CPU without a JAX render."""
    cfg = dataclasses.replace(tpresets.cornell_box_camera(), image_width=64, aspect_ratio=1.0,
                              samples_per_pixel=16, max_depth=5, integrator=integrator)
    scene = tpresets.cornell_box(device="cpu")
    cc = camera_constants(cfg, torch.float32)
    fb = torch.zeros((64 * 64, 3))
    trender._render_strata(scene, cfg, cc, integrator, 1234, fb, None, None, None)
    img = trender.RenderResult(fb.numpy().reshape(64, 64, 3), 16, None, 64, 64).rgb8()
    golden = read_png(os.path.join(ROOT, "tests", "golden", f"cornell_{integrator}.png"))
    assert img.shape == golden.shape and img.any()
    # bdpt: XLA contracts the connections' geometry on a CPU, which flips
    # ~0.08% of the visible pairs at float32 (465,174 vs 465,528 shadow
    # rays), each an unweighted contribution: RMSE 0.0105 (pt: 0.0013)
    assert _rmse(img, golden) < (0.004 if integrator == "pt" else 0.015)


def test_cli_f64_on_cpu_without_jax(tmp_path):
    """--f64 --device cpu renders the cornell box in float64 through the
    stratum loop (its BDPT default) and writes render()'s image."""
    code = ("import sys\nfrom bpt_tpu_torch.render import main\nrc = main(sys.argv[1:])\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'bpt_tpu')]\n"
            "sys.exit(rc)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--f64", "--device", "cpu", "--size", "8x8", "--spp", "4",
         "--max-depth", str(DEPTH), "--output", "f.png", "--output-dir", str(tmp_path),
         "--no-progress"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    scene, cfg = _f64("bdpt", aspect_ratio=1.0)
    want = trender.render(scene, cfg, seed=0)
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")), want.rgb8())
    assert f"shadow rays:     {want.stats.shadow_rays}" in proc.stderr


def test_pt_wave_defocus_jitter_matches_bpt_tpu():
    """pt_wave's primary rays with a defocus disk draw the jitter pair and
    the disk pair from bpt_tpu's _raygen_jitter_host(defocus=True)."""
    ids = np.arange(1000, dtype=np.int32) * 7 + 3
    want = _raygen_jitter_host(jax.random.PRNGKey(42), jnp.asarray(ids), defocus=True)
    got = rng.raygen_jitter(rng.prng_key(42), torch.from_numpy(ids), defocus=True)
    assert len(got) == len(want) == 4
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    two = rng.raygen_jitter(rng.prng_key(42), torch.from_numpy(ids))
    assert all(torch.equal(a, b) for a, b in zip(two, got[:2]))
