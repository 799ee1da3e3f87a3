"""bpt_tpu_torch's megakernels on scenes over 512 triangles against
bpt_tpu on a CPU: the walk mode of the PT and BDPT megakernels, the
counterpart of the clustered mode of bpt_tpu's Pallas kernels 1-2 and 5-6,
and the routes that take it.

The plain versions of the walk mode (the port's wavefront on the kernel's
stream over ``ops.soa.bvh_closest`` / ``bvh_any``) are held against
bpt_tpu's clustered megakernels in interpret mode on
``torch_parity.big_scene`` (964 triangles) at depth 3, with injected
uniforms as ``tests/test_pallas_kernels.py`` runs them (PT at B = 128,
BDPT and BDPT-MIS at B = 64) and on the kernel's own threefry stream.
Radiance within rtol 1e-4 / atol 1e-5, rays exact, and shadow rays
exact for bdpt-mis.  bdpt's differ by connections between two points of
the floor's plane, whose cosines are ~1e-8: XLA's CPU backend contracts
the hit point o + t*d into one rounding and PyTorch does not, so such a
pair passes the cosine test on one side only (ROADMAP §3; bdpt-mis's
one-sided test removes them); the gap is held within the port's visible
pairs on that plane.  The four walk counters are not bpt_tpu's (its
clustered kernel counts cluster tiles: ROADMAP §3, "Counters"); they are
held to the walks the plain version runs, summed by hand: every
``bvh_closest`` walk adds its node visits, box hits, triangle tests and
accepted tests, every ``bvh_any`` walk all but the last, as the CUDA
kernel counts them.

Then ``models.render._route`` against bpt_tpu's routing constants (2^18
pixels or samples, depth 32), and the BDPT wave route, which never calls
the megakernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.models import pt as jpt
from bpt_tpu.ops.pallas import bdpt_kernel as jbk
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.kernels import bdpt_kernel as tbk
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_scene

RTOL, ATOL, DEPTH = 1e-4, 1e-5, 3


@pytest.fixture(scope="module")
def scenes():
    js = big_scene(jbuilder, dtype=jnp.float32)
    ts = big_scene(tbuilder, device="cpu")
    assert jk.use_clusters(js) and jk.megakernel_reject_reason(js) == ""
    assert tk.use_walk(ts) and tk.megakernel_reject_reason(ts, "bdpt-mis") == ""
    return js, ts


@pytest.fixture
def walks(monkeypatch):
    """Sums the counters of every BVH walk the plain versions run: all four
    of the closest walks, node visits, box hits and triangle tests of the
    any-hit walks."""
    total = torch.zeros(4, dtype=torch.int64)
    closest, any_ = tsoa.bvh_closest, tsoa.bvh_any

    def closest_spy(*a, **k):
        h = closest(*a, **k)
        total.add_(torch.stack([h.node_visits, h.aabb_hits, h.tri_tests, h.tri_hits]))
        return h

    def any_spy(*a, **k):
        hit, c = any_(*a, **k)
        total[:3] += c[:3]
        return hit, c

    closest_spy.calls = any_spy.calls = 0  # the walks count their calls
    monkeypatch.setattr(tsoa, "bvh_closest", closest_spy)
    monkeypatch.setattr(tsoa, "bvh_any", any_spy)
    return total


@pytest.fixture
def floor_pairs(monkeypatch):
    """Counts the visible connections the plain versions test along the
    floor's plane (|direction y| < 1e-5)."""
    n = [0]
    counted = tsoa.any_hit_counted

    def spy(scene, o, d, tmin, tmax, mask=None, plain=False):
        hit, c = counted(scene, o, d, tmin, tmax, mask=mask, plain=plain)
        n[0] += int((mask & ~hit & (d.y.abs() < 1e-5)).sum())
        return hit, c

    monkeypatch.setattr(tsoa, "any_hit_counted", spy)
    return n


def _aimed_rays(B, seed):
    """bpt_tpu's clustered-kernel tests' rays: from (0, 2, 6) at the
    sphere and the floor (test_pallas_kernels.py:351-360)."""
    g = np.random.default_rng(seed)
    o = np.tile([[0.0, 2.0, 6.0]], (B, 1)).astype(np.float32)
    tgt = np.concatenate([g.uniform(-2, 2, (B, 1)), g.uniform(0, 3, (B, 1)),
                          np.zeros((B, 1))], 1)
    return o, (tgt - np.array([0.0, 2.0, 6.0])).astype(np.float32), g


def _pallas_stream(estimator, key, ids):
    """The Pallas kernels' in-kernel threefry stream of lanes ``ids`` as an
    injected-uniform buffer, from bpt_tpu's own helpers: PT's paired draws
    (models/pt.py::kernel_stream_uniforms_fn), BDPT's word x0 of
    threefry(slot key, (ray id, 0)) (bdpt_kernel.py::_subkeys_bdpt)."""
    ids = jnp.asarray(ids)
    if estimator == "pt":
        fn = jpt.kernel_stream_uniforms_fn(key, ids, jnp.float32)
        return np.concatenate([np.stack(fn(b, jpt.NU)) for b in range(DEPTH)])
    keys = jbk._subkeys_bdpt(key, DEPTH)
    ru = ids.astype(jnp.uint32)
    rows = [jk._threefry2x32(keys[2 * s], keys[2 * s + 1], ru, jnp.zeros_like(ru))[0]
            for s in range(jbk.n_uniform_slots(DEPTH))]
    return np.stack([np.asarray(jk._bits_to_unit_float(r)) for r in rows])


ESTIMATORS = {"pt": (128, 31, 6), "bdpt": (64, 41, 4), "bdpt-mis": (64, 41, 4)}
_PALLAS = {}


def _pallas(estimator):
    """One interpret-mode launch of bpt_tpu's clustered megakernel on 2B
    lanes, the first B fed random uniforms, the last B their own kernel
    stream (one launch for both cases: interpret mode costs seconds a
    launch whatever B is).  Returns (o, d, ids, uniforms, outputs)."""
    if estimator not in _PALLAS:
        B, seed, k = ESTIMATORS[estimator]
        js = big_scene(jbuilder, dtype=jnp.float32)
        o, d, g = _aimed_rays(2 * B, seed)
        ids = np.arange(2 * B, dtype=np.int32)
        slots = DEPTH * jpt.NU if estimator == "pt" else jbk.n_uniform_slots(DEPTH)
        u = np.concatenate([g.uniform(size=(slots, B)).astype(np.float32),
                            _pallas_stream(estimator, jax.random.PRNGKey(k), ids[B:])], 1)
        args = (js, jv3.from_array(jnp.asarray(o)), jv3.from_array(jnp.asarray(d)),
                jnp.asarray(ids), jax.random.PRNGKey(k), DEPTH)
        if estimator == "pt":
            out = jk.pt_megakernel(*args, uniforms=jnp.asarray(u), interpret=True)
        else:
            out = jbk.bdpt_megakernel(*args, uniforms=jnp.asarray(u), interpret=True,
                                      mis=estimator == "bdpt-mis")
        _PALLAS[estimator] = (o, d, ids, u, [np.asarray(x) for x in out])
    return _PALLAS[estimator]


def _port(ts, estimator, o, d, ids, u):
    """The port's megakernel wrapper on CPU tensors: its plain version.
    Returns (radiance x3, rays, shadow rays, walk counters int64[4])."""
    k = ESTIMATORS[estimator][2]
    args = (ts, Vec3(*torch.from_numpy(o).unbind(1)), Vec3(*torch.from_numpy(d).unbind(1)),
            torch.from_numpy(ids), rng.prng_key(k), DEPTH)
    uniforms = None if u is None else torch.from_numpy(np.ascontiguousarray(u))
    if estimator == "pt":
        calls = tk.pt_megakernel_plain.calls
        out = tk.pt_megakernel(*args, uniforms=uniforms)
        assert tk.pt_megakernel_plain.calls == calls + 1
        return list(out[:4]) + [torch.zeros((), dtype=torch.int64), out[4]]
    calls = tbk.bdpt_megakernel_plain.calls
    out = tbk.bdpt_megakernel(*args, uniforms=uniforms, mis=estimator == "bdpt-mis")
    assert tbk.bdpt_megakernel_plain.calls == calls + 1
    return list(out)


def _radiance(out):
    return np.stack([np.asarray(x) for x in out[:3]], -1)


@pytest.mark.parametrize("stream", ["buffer", "rng"])
@pytest.mark.parametrize("estimator", list(ESTIMATORS))
def test_walk_mode_matches_clustered_pallas(scenes, walks, floor_pairs, estimator, stream):
    """Injected uniforms (``buffer``), or the port's in-kernel stream
    (``rng``, no uniforms) against bpt_tpu's kernel fed its own stream."""
    _, ts = scenes
    o, d, ids, u, want = _pallas(estimator)
    B = ids.shape[0] // 2
    half = slice(0, B) if stream == "buffer" else slice(B, 2 * B)
    other = slice(B, 2 * B) if stream == "buffer" else slice(0, B)
    got = _port(ts, estimator, o[half], d[half], ids[half],
                u[:, half] if stream == "buffer" else None)
    np.testing.assert_allclose(_radiance(got), _radiance(want)[half], rtol=RTOL, atol=ATOL)
    assert float(_radiance(got).sum()) > 0
    # the walk counters: every walk the plain version ran
    assert got[5].tolist() == walks.tolist()
    assert walks[0] > walks[1] > 0 and walks[2] >= walks[3] > 0
    # rays and shadow rays over the launch's lanes, both halves
    rest = _port(ts, estimator, o[other], d[other], ids[other],
                 u[:, other] if stream == "rng" else None)
    assert int(got[3]) + int(rest[3]) == int(want[3]) > 2 * B
    shadow = int(got[4]) + int(rest[4])
    if estimator == "bdpt-mis":
        assert shadow == int(want[4]) > 0
    elif estimator == "bdpt":
        assert 0 < abs(shadow - int(want[4])) <= floor_pairs[0] < shadow / 2


def test_walk_pixels_modes_count_their_walks(scenes, walks):
    """The pixels modes' plain versions on the big scene (2x2 strata of a
    6x6 image) count every walk they run, as the rays modes do."""
    _, ts = scenes
    cfg = CameraConfig(image_width=6, aspect_ratio=1.0, samples_per_pixel=4, max_depth=DEPTH,
                       vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    cam = tk.camera_table(camera_constants(cfg))
    pix = torch.arange(36)
    i, j = (pix % 6).float(), (pix // 6).float()
    pt = tk.pt_megakernel_pixels(ts, i, j, i * 0, j * 0, pix, cam, rng.prng_key(2), DEPTH,
                                 spp_loop=4, sqrt_spp=2)
    assert pt[4].tolist() == walks.tolist() and int(pt[3]) > 4 * 36
    walks.zero_()
    bd = tbk.bdpt_megakernel_pixels(ts, i, j, pix, cam, rng.prng_key(2), DEPTH, 2, mis=True)
    assert bd[5].tolist() == walks.tolist() and 0 < int(bd[4])
    assert walks[2] > bd[5][3] > 0


def _cfg(width, height, spp, depth, integrator, **kw):
    return CameraConfig(image_width=width, aspect_ratio=width / height, samples_per_pixel=spp,
                        max_depth=depth, vfov=40.0, lookfrom=(0.0, 2.0, 6.0),
                        lookat=(0.0, 1.0, 0.0), integrator=integrator, **kw)


def test_route_table(scenes):
    """bpt_tpu's order with its constants: the BDPT wave from 2^18 samples
    to depth 32, the fused loop (the walk mode) below or past them, the
    stratum loop for defocus, ref_vis and float64; PT on the big scene
    takes pt_wave also under 2^18 pixels, where bpt_tpu takes the fused
    loop, unless with defocus."""
    _, big = scenes
    small = tpresets.cornell_box(device="cpu")
    big64 = big_scene(tbuilder, device="cpu", dtype=torch.float64)
    under = (511, 513, 1)  # 2^18 - 1 pixels and samples
    assert 511 * 513 == (1 << 18) - 1 and _cfg(*under, 10, "pt").image_height == 513
    jnp_snap = dict(strata_done=1, units_done=1, unit_kind="stratum", stream="jnp")
    table = [
        (big, (512, 512, 1, 10, "pt"), {}, None, "wave"),
        (big, (*under, 10, "pt"), {}, None, "wave"),
        (big, (512, 512, 1, 10, "pt"), dict(defocus_angle=1.0), None, "wave"),
        (big, (256, 256, 16, 10, "pt"), {}, None, "wave"),
        (big, (256, 256, 16, 10, "pt"), {}, dict(jnp_snap, unit_kind="chunk"), "fused"),
        (big, (256, 256, 4, 10, "pt"), dict(defocus_angle=1.0), None, "strata"),
        (small, (512, 512, 16, 10, "pt"), {}, None, "fused"),
        (big, (512, 512, 1, 10, "bdpt"), {}, None, "bdpt_wave"),
        (big, (*under, 10, "bdpt"), {}, None, "fused"),
        (big, (256, 256, 4, 32, "bdpt-mis"), {}, None, "bdpt_wave"),
        (big, (256, 256, 4, 33, "bdpt-mis"), {}, None, "fused"),
        (big, (512, 512, 4, 80, "bdpt-mis"), {}, None, "fused"),
        (big, (512, 512, 4, 10, "bdpt-mis"), dict(defocus_angle=1.0), None, "bdpt_wave"),
        (big, (128, 128, 4, 10, "bdpt"), dict(defocus_angle=1.0), None, "strata"),
        (big, (512, 512, 4, 10, "bdpt"), dict(ref_vis=True), None, "strata"),
        (big, (512, 512, 4, 10, "bdpt"), {}, jnp_snap, "bdpt_wave"),
        (big, (128, 128, 4, 10, "bdpt"), {}, jnp_snap, "strata"),
        (big, (512, 512, 4, 10, "bdpt"), {}, dict(jnp_snap, stream="wave"), "strata"),
        (big64, (512, 512, 4, 10, "bdpt"), {}, None, "strata"),
        (small, (512, 512, 16, 10, "bdpt"), {}, None, "fused"),
    ]
    for scene, args, kw, resume, want in table:
        cfg = _cfg(*args, **kw)
        assert trender._route(scene, cfg, args[-1], resume) == want, (args, kw, resume)


def test_bdpt_wave_route_never_calls_the_megakernel(scenes, monkeypatch):
    """With the megakernel taking the scene, as on the card, the stratum
    loop's BDPT estimator calls it (its plain version on CPU tensors) and
    the BDPT wave loop does not: launches and plain calls stay 0 there,
    and its image is the jnp estimator's."""
    _, ts = scenes
    monkeypatch.setattr(tbdpt, "_megakernel_ok", lambda scene: True)
    cfg = _cfg(4, 4, 4, DEPTH, "bdpt-mis")
    cc = camera_constants(cfg)
    counts = {}
    fbs = {}
    for wave in (False, True):
        before = (tbk.bdpt_megakernel.launches, tbk.bdpt_megakernel_plain.calls)
        fbs[wave] = torch.zeros((16, 3))
        trender._render_strata(ts, cfg, cc, "bdpt-mis", 1, fbs[wave], None, None, None,
                               bdpt_wave=wave)
        counts[wave] = (tbk.bdpt_megakernel.launches - before[0],
                        tbk.bdpt_megakernel_plain.calls - before[1])
    assert counts == {False: (0, 1), True: (0, 0)}
    monkeypatch.setattr(tbdpt, "_megakernel_ok", lambda scene: False)
    jnp_fb = torch.zeros((16, 3))
    trender._render_strata(ts, cfg, cc, "bdpt-mis", 1, jnp_fb, None, None, None)
    assert torch.equal(fbs[True], jnp_fb) and not torch.equal(fbs[False], jnp_fb)
