"""bpt_tpu_torch PT estimator and megakernel plain versions against
bpt_tpu.

f64 (conftest's x64): brute closest/any hit and path_trace_radiance with
injected uniforms agree to 1e-10 and count exactly.  f32: the plain
versions of pt_megakernel (injected-uniform and RNG mode) and
pt_megakernel_pixels agree with the Pallas kernels run in interpret mode
at the tolerance of test_megakernel_matches_jnp_with_injected_uniforms
(rtol 1e-4, atol 1e-6), with exact rays / tri tests / tri hits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import onb as jonb
from bpt_tpu.core import sampling as jsamp
from bpt_tpu.core import vec3 as jv3
from bpt_tpu.core import vecmath as jvm
from bpt_tpu.models import camera as jcam
from bpt_tpu.models import pt as jpt
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import presets as jpresets
from bpt_tpu_torch.core import onb as tonb
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core import sampling as tsamp
from bpt_tpu_torch.core import vec3 as tv3
from bpt_tpu_torch.core import vecmath as tvm
from bpt_tpu_torch.models import camera as tcam
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from torch_parity import endpoint_ties, mixed_scene, rays, shadow_wave

RTOL, ATOL = 1e-4, 1e-6


def _scenes(which, dt):
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else (jnp.float32, torch.float32)
    if which == "cornell":
        return jpresets.cornell_box(dtype=jdt), tpresets.cornell_box(device="cpu", dtype=tdt)
    return (mixed_scene(jbuilder, jpresets, dtype=jdt),
            mixed_scene(tbuilder, tpresets, device="cpu", dtype=tdt))


def _vec(a, lib):
    if lib == "jax":
        return jv3.from_array(jnp.asarray(a))
    return tv3.from_array(torch.from_numpy(a))


# ------------------------------------------------------------- f64 oracle

_LIBS = {"jax": (jvm, jonb, jsamp, jnp.asarray, jnp.stack),
         "torch": (tvm, tonb, tsamp, torch.from_numpy, torch.stack)}
_CORE = {
    "reflect": lambda vm, on, sa, st, a, b, u1, u2: vm.reflect(a, vm.unit_vector(b)),
    "refract": lambda vm, on, sa, st, a, b, u1, u2: vm.refract(
        vm.unit_vector(a), vm.unit_vector(b), u1 + 0.5),
    "normalize_safe": lambda vm, on, sa, st, a, b, u1, u2: vm.normalize_safe(a * u1[:, None]),
    "schlick": lambda vm, on, sa, st, a, b, u1, u2: vm.schlick_reflectance(u1, 1.0 + u2),
    "onb": lambda vm, on, sa, st, a, b, u1, u2: st(on.onb_from_w(a), 0),
    "cosine_world": lambda vm, on, sa, st, a, b, u1, u2: sa.cosine_direction_world(a, u1, u2),
    "cosine_pdf": lambda vm, on, sa, st, a, b, u1, u2: sa.cosine_pdf_value(a, vm.unit_vector(b)),
    "sphere": lambda vm, on, sa, st, a, b, u1, u2: sa.uniform_sphere_direction(u1, u2),
    "disk": lambda vm, on, sa, st, a, b, u1, u2: sa.unit_disk_point(u1, u2),
    "barycentric": lambda vm, on, sa, st, a, b, u1, u2: st(sa.triangle_barycentric(u1, u2), 0),
}


@pytest.mark.parametrize("fn", list(_CORE))
def test_core_vector_math_matches_f64(fn):
    g = np.random.default_rng(len(fn))
    a, b = g.normal(size=(257, 3)), g.normal(size=(257, 3))
    u1, u2 = g.uniform(size=257), g.uniform(size=257)
    a[:3, 0] = [0.95, -0.95, 0.1]  # both ONB helper axes
    out = {}
    for name, (vm, on, sa, conv, st) in _LIBS.items():
        out[name] = np.asarray(_CORE[fn](vm, on, sa, st, *(conv(x) for x in (a, b, u1, u2))))
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_brute_hits_match_f64(kind):
    js, ts = _scenes("mixed", "f64")
    o, d = (x.astype(np.float64) for x in rays(300, 11))
    tmin = np.full(300, 1e-3)
    tmax = np.random.default_rng(12).uniform(10, 2000, 300)
    if kind == "any":
        want = jsoa.brute_any(js, _vec(o, "jax"), _vec(d, "jax"),
                              jnp.asarray(tmin), jnp.asarray(tmax))
        got = tsoa.brute_any(ts, _vec(o, "t"), _vec(d, "t"),
                             torch.from_numpy(tmin), torch.from_numpy(tmax))
        assert 0 < int(got.sum()) < 300
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        mask = np.arange(300) % 3 > 0
        want = jsoa.any_hit(js, _vec(o, "jax"), _vec(d, "jax"), 1e-3,
                            jnp.asarray(tmax), mask=jnp.asarray(mask))
        got = tsoa.any_hit(ts, _vec(o, "t"), _vec(d, "t"), 1e-3,
                           torch.from_numpy(tmax), mask=torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    want = jsoa.brute_closest(js, _vec(o, "jax"), _vec(d, "jax"),
                              jnp.asarray(tmin), jnp.asarray(tmax))
    got = tsoa.brute_closest(ts, _vec(o, "t"), _vec(d, "t"),
                             torch.from_numpy(tmin), torch.from_numpy(tmax))
    m = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), m)
    np.testing.assert_array_equal(got.tri.numpy()[m], np.asarray(want.tri)[m])
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[m],
                                   np.asarray(getattr(want, name))[m],
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    assert int(got.tri_tests) == int(want.tri_tests)
    assert int(got.tri_hits) == int(want.tri_hits)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_brute_hits_on_a_shadow_wave_match_f64(kind):
    """closest_tri / any_tri (their plain versions on the CPU) at float64 on
    a shadow wave's layout (torch_parity.shadow_wave: 5 light rows of 512
    lanes, sparser row by row, runs of dead lanes, masked and NaN lanes)
    against bpt_tpu's brute_closest / brute_any, with endpoint ties (tmax
    the hit's own t where both sides put it alike, inclusive): every answer
    and triangle equal, t, u, v to 1e-10, every tie a hit."""
    from bpt_tpu_torch.ops.kernels import intersect as ki

    js, ts = _scenes("mixed", "f64")
    o, d, tmin, tmax, live = shadow_wave(5, 512, 17, np.float64)

    def args(tm):
        return ((js, _vec(o, "jax"), _vec(d, "jax"), jnp.asarray(tmin), jnp.asarray(tm)),
                (ts, _vec(o, "t"), _vec(d, "t"), torch.from_numpy(tmin), torch.from_numpy(tm)))

    far = np.where(live, np.inf, tmax)
    (ja, ta) = args(far)
    tmax, ties = endpoint_ties(tmax, live, np.asarray(jsoa.brute_closest(*ja).t),
                               ki.closest_tri(*ta)[0].numpy())
    assert ties.sum() >= 100
    ja, ta = args(tmax)
    dead = ~(tmin <= tmax)
    if kind == "any":
        got = ki.any_tri(*ta).numpy()
        np.testing.assert_array_equal(got, np.asarray(jsoa.brute_any(*ja)))
        assert got[ties].all() and not got[dead].any()
        return
    want = jsoa.brute_closest(*ja)
    t, tri, u, v = (x.numpy() for x in ki.closest_tri(*ta))
    m = np.asarray(want.hit)
    np.testing.assert_array_equal(tri >= 0, m)
    assert m[ties].all() and (t[ties] == tmax[ties]).all() and not m[dead].any()
    np.testing.assert_array_equal(tri[m], np.asarray(want.tri)[m])
    for name, got in (("t", t), ("u", u), ("v", v)):
        np.testing.assert_allclose(got[m], np.asarray(getattr(want, name))[m], rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    assert np.isinf(t[~m]).all() and not np.c_[u, v][~m].any()


@pytest.mark.parametrize("which", ["cornell", "mixed"])
@pytest.mark.parametrize("depth", [1, 4])
def test_path_trace_radiance_matches_f64(which, depth):
    js, ts = _scenes(which, "f64")
    B = 300
    o, d = (x.astype(np.float64) for x in rays(B, depth))
    U = np.random.default_rng(depth).uniform(size=(B, depth, jpt.NU))
    rad_j, st_j = jpt.path_trace_radiance(js, jnp.asarray(o), jnp.asarray(d),
                                          depth, jpt.array_uniforms_fn(jnp.asarray(U)))
    rad_t, st_t = tpt.path_trace_radiance(ts, torch.from_numpy(o), torch.from_numpy(d),
                                          depth, tpt.array_uniforms_fn(torch.from_numpy(U)))
    assert rad_t.dtype == torch.float64
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=1e-10, atol=1e-10)
    for name in st_j._fields:
        assert int(getattr(st_t, name)) == int(getattr(st_j, name)), name


# ------------------------------------------------- f32 kernel plain versions


def _assert_kernel_outputs(got, want):
    g = np.stack([t.numpy() for t in got[:3]], -1)
    w = np.stack([np.asarray(x) for x in want[:3]], -1)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert int(got[3]) == int(want[3])  # rays
    g_extra = [int(x) for x in got[4]]
    w_extra = [int(x) for x in np.asarray(want[4])]
    assert g_extra == w_extra  # node visits, aabb hits, tri tests, tri hits
    assert g_extra[2] > 0 and g_extra[3] > 0


def _lane_ids(B):
    ids = np.arange(B, dtype=np.int32)
    ids[::17] = -1  # inactive lanes contribute nothing and count nothing
    return ids


@pytest.mark.parametrize("which,depth", [("cornell", 1), ("cornell", 4), ("mixed", 4)])
def test_plain_megakernel_injected_matches_pallas(which, depth):
    js, ts = _scenes(which, "f32")
    B = 300
    o, d = rays(B, 40 + depth)
    ids = _lane_ids(B)
    U = np.random.default_rng(depth).uniform(size=(depth * jpt.NU, B)).astype(np.float32)
    want = jk.pt_megakernel(js, _vec(o, "jax"), _vec(d, "jax"), jnp.asarray(ids),
                            jax.random.PRNGKey(0), depth, uniforms=jnp.asarray(U),
                            interpret=True)
    calls = tk.pt_megakernel_plain.calls
    got = tk.pt_megakernel(ts, _vec(o, "t"), _vec(d, "t"), torch.from_numpy(ids),
                           rng.prng_key(0), depth, uniforms=torch.from_numpy(U))
    assert tk.pt_megakernel_plain.calls == calls + 1  # CPU tensors: plain version
    _assert_kernel_outputs(got, want)
    assert all(float(c[::17].abs().max()) == 0.0 for c in got[:3])


@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_plain_megakernel_rng_mode_matches_pallas(which):
    js, ts = _scenes(which, "f32")
    B, depth = 300, 4
    o, d = rays(B, 77)
    ids = _lane_ids(B) * 3 + 1000
    ids[::17] = -1
    want = jk.pt_megakernel(js, _vec(o, "jax"), _vec(d, "jax"), jnp.asarray(ids),
                            jax.random.PRNGKey(5), depth, interpret=True)
    got = tk.pt_megakernel(ts, _vec(o, "t"), _vec(d, "t"), torch.from_numpy(ids),
                           rng.prng_key(5), depth)
    if which == "cornell":
        _assert_kernel_outputs(got, want)
        return
    # On the mixed scene one lane (id 1339) leaves the dielectric box face
    # from a point exactly on it (x = 340.0) and its depth-4 ray grazes
    # an edge: the Pallas kernel (product-chain Schlick, its own op order)
    # and bpt_tpu's jnp wavefront disagree on that hit in f32 by one
    # lane-bounce.  The plain version is the jnp wavefront's port, so its
    # counters are held exactly to the jnp wavefront on the kernel stream,
    # and its radiance to both.
    act = ids >= 0
    _, st = jpt.path_trace_radiance(
        js, jnp.asarray(o[act]), jnp.asarray(d[act]), depth,
        jpt.kernel_stream_uniforms_fn(jax.random.PRNGKey(5),
                                      jnp.asarray(ids[act]), jnp.float32))
    _assert_kernel_outputs(got, want[:3] + (
        st.rays_traced, [st.node_visits, st.aabb_hits, st.tri_tests, st.tri_hits]))
    assert int(got[3]) == int(want[3]) + 1


@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_plain_megakernel_pixels_matches_pallas(which):
    import dataclasses

    js, ts = _scenes(which, "f32")
    W, S = 8, 2
    kw = dict(image_width=W, samples_per_pixel=S * S)
    ccj = jcam.camera_constants(
        dataclasses.replace(jpresets.cornell_box_camera(), **kw), jnp.float32)
    cct = tcam.camera_constants(
        dataclasses.replace(tpresets.cornell_box_camera(), **kw), torch.float32)
    pix = np.arange(W * W, dtype=np.int32)
    pix[-3:] = -1
    i = (np.arange(W * W) % W).astype(np.float32)
    j = (np.arange(W * W) // W).astype(np.float32)
    want = jk.pt_megakernel_pixels(js, jnp.asarray(i), jnp.asarray(j), jnp.asarray(i * 0),
                                   jnp.asarray(j * 0), jnp.asarray(pix),
                                   jk.camera_table(ccj), jax.random.PRNGKey(7), 3,
                                   interpret=True, spp_loop=S * S, sqrt_spp=S)
    ti, tj = torch.from_numpy(i), torch.from_numpy(j)
    got = tk.pt_megakernel_pixels(ts, ti, tj, ti * 0, tj * 0, torch.from_numpy(pix),
                                  tk.camera_table(cct), rng.prng_key(7), 3,
                                  spp_loop=S * S, sqrt_spp=S)
    _assert_kernel_outputs(got, want)


def test_reject_reasons():
    scene = tpresets.cornell_box(device="cpu")
    assert tk.megakernel_reject_reason(scene) == ""
    assert tk.megakernel_reject_reason(scene, "bdpt") == ""
    assert tk.megakernel_reject_reason(scene, "bdpt-mis") == ""
    assert "unknown integrator" in tk.megakernel_reject_reason(scene, "mlt")
    assert "float32" in tk.megakernel_reject_reason(tpresets.cornell_box(device="cpu", dtype=torch.float64))
    b = tbuilder.SceneBuilder()
    mats = [tbuilder.MaterialSpec.lambertian((0.1 * k, 0.1, 0.1)) for k in range(17)]
    for k, m in enumerate(mats):
        b.add_triangle((k, 0, 0), (k + 1, 0, 0), (k, 1, 0), m)
    b.add_triangle((0, 5, 0), (1, 5, 0), (0, 5, 1), tbuilder.MaterialSpec.diffuse_light((1, 1, 1)))
    assert "MAX_MATS" in tk.megakernel_reject_reason(b.build(device="cpu"))
