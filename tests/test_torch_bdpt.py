"""bpt_tpu_torch BDPT against bpt_tpu: the BDPT kernel stream, the light
tables, the shading helpers BDPT adds, the wavefront at f64, and the
megakernel's plain versions against the Pallas kernels in interpret mode.

Tolerances.  f64 wavefront (conftest's x64): 1e-10, every counter equal.
f32 plain version vs Pallas kernel: rtol 1e-4 / atol 1e-5 on >= 97% of
lanes, rays and tri_hits exact, shadow rays and shadow-test candidates
(tri_tests by the kernel's definition: T per traced bounce + T per
candidate) within 3%.  The f32 gap is not the port's: on the cornell box
vertices on one axis-aligned wall connect with cos exactly 0 or ~1e-8, and
shadow rays that leave a surface at a grazing angle re-hit it just past
T_MIN, so a one-ulp difference in a hit point flips such pairs.  XLA's CPU
backend contracts a*b+c and has its own sin/cos; PyTorch's CPU kernels do
neither.  Measured at B=128, depth 4: 14 of 862 candidates and 1 of 616
visible pairs, each of the differing lanes one candidate apart (bpt_tpu's
own jnp wavefront differs from its Pallas kernel the same way).  On the
card the kernel and the plain version round alike and are held exactly
(chip_smoke.py, test_torch_cuda_kernels.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.models import bdpt as jbdpt
from bpt_tpu.models import camera as jcam
from bpt_tpu.models import pt as jpt
from bpt_tpu.ops import shade_soa as jsh
from bpt_tpu.ops.pallas import bdpt_kernel as jbk
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import presets as jpresets
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core import vec3 as tv3
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import camera as tcam
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.ops import shade_soa as tsh
from bpt_tpu_torch.ops.kernels import bdpt_kernel as tbk
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from torch_parity import mixed_scene, rays

RTOL, ATOL, MIN_FRAC, COUNT_REL = 1e-4, 1e-5, 0.97, 0.03
B, DEPTH = 128, 4


def _scenes(which, dt):
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else (jnp.float32, torch.float32)
    if which == "cornell":
        return jpresets.cornell_box(dtype=jdt), tpresets.cornell_box(device="cpu", dtype=tdt)
    return (mixed_scene(jbuilder, jpresets, dtype=jdt),
            mixed_scene(tbuilder, tpresets, device="cpu", dtype=tdt))


def _bits(a):
    return np.asarray(a).view(np.uint32)


# ------------------------------------------------------------- the stream


@pytest.mark.parametrize("depth", [1, 4, 10])
def test_n_uniform_slots_matches(depth):
    assert rng.n_uniform_slots(depth) == jbk.n_uniform_slots(depth)


@pytest.mark.parametrize("raygen", [False, True], ids=["rays", "raygen"])
def test_subkeys_bdpt_bitequal(raygen):
    key = jax.random.PRNGKey(13)
    fn_j = jbk._subkeys_bdpt_raygen if raygen else jbk._subkeys_bdpt
    fn_t = rng.subkeys_bdpt_raygen if raygen else rng.subkeys_bdpt
    want = [int(x) for x in np.asarray(fn_j(key, 5))]
    assert want == fn_t(rng.prng_key(13), 5)


def _pallas_draw(keys, slot, ids):
    """Word x0 of threefry(keys[slot], (rid, 0)): the Pallas kernel's draw."""
    ru = jnp.asarray(ids).astype(jnp.uint32)
    bits, _ = jk._threefry2x32(jnp.uint32(keys[2 * slot]), jnp.uint32(keys[2 * slot + 1]),
                               ru, jnp.zeros_like(ru))
    return jk._bits_to_unit_float(bits)


@pytest.mark.parametrize("section", ["camera", "light_start", "light"])
def test_bdpt_stream_rows_bitequal(section):
    depth = 4
    ids = np.random.default_rng(6).integers(0, 2**31 - 1, 300).astype(np.int32)
    keys = np.asarray(jbk._subkeys_bdpt(jax.random.PRNGKey(3), depth))
    cam_fn, ls_rows, light_fn = rng.bdpt_kernel_stream_uniforms_fn(
        rng.prng_key(3), torch.from_numpy(ids), depth, torch.float32)
    if section == "camera":
        pairs = [(b * 5 + s, cam_fn(b, 5)[s]) for b in (0, 3) for s in range(5)]
    elif section == "light_start":
        pairs = [(depth * 5 + s, ls_rows[s]) for s in range(5)]
    else:
        pairs = [(depth * 5 + 5 + b * 5 + s, light_fn(b, 5)[s]) for b in (0, 2)
                 for s in range(5)]
    for slot, row in pairs:
        np.testing.assert_array_equal(_bits(_pallas_draw(keys, slot, ids)),
                                      row.numpy().view(np.uint32), err_msg=str(slot))


def test_bdpt_raygen_jitter_bitequal():
    depth = 3
    ids = np.arange(0, 4096 * 16, 7, dtype=np.int32)
    keys = np.asarray(jbk._subkeys_bdpt_raygen(jax.random.PRNGKey(9), depth))
    nj = jbk.n_uniform_slots(depth)
    got = rng.bdpt_raygen_jitter(rng.prng_key(9), torch.from_numpy(ids))
    for k, g in enumerate(got):
        np.testing.assert_array_equal(_bits(_pallas_draw(keys, nj + k, ids)),
                                      g.numpy().view(np.uint32))


# ------------------------------------------------------- scene and shading


@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_pack_tables_bdpt_equal(which):
    js, ts = _scenes(which, "f32")
    assert tk.megakernel_reject_reason(ts, "bdpt-mis") == ""
    for w, g in zip(jbk._pack_tables_bdpt(js), tbk._pack_tables_bdpt(ts)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_sample_surface_and_evaluate_bsdf_match_f64(which):
    js, ts = _scenes(which, "f64")
    u = np.random.default_rng(8).uniform(size=(3, 500))
    u[0, :3] = [0.0, 0.5, 1.0 - 1e-12]
    want = jsh.sample_surface(js, *(jnp.asarray(x) for x in u))
    got = tsh.sample_surface(ts, *(torch.from_numpy(x) for x in u))
    for name in ("position", "normal"):
        np.testing.assert_allclose(tv3.to_array(getattr(got, name)).numpy(),
                                   np.asarray(jv3.to_array(getattr(want, name))),
                                   rtol=1e-12, atol=1e-9, err_msg=name)
    for name in ("mat", "pdf", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    mats = np.arange(int(ts.materials.mtype.shape[0]))
    zero = jnp.zeros(mats.shape, jnp.float64)
    want = jsh.evaluate_bsdf(js, jnp.asarray(mats), js.materials.mtype[mats], zero, zero,
                             jv3.Vec3(zero, zero, zero))
    tzero = torch.zeros(mats.shape, dtype=torch.float64)
    got = tsh.evaluate_bsdf(ts, torch.from_numpy(mats), ts.materials.mtype[mats], tzero,
                            tzero, tv3.Vec3(tzero, tzero, tzero))
    np.testing.assert_allclose(tv3.to_array(got).numpy(), np.asarray(jv3.to_array(want)),
                               rtol=1e-15, atol=0)


# ------------------------------------------------------- wavefront at f64


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_bdpt_radiance_matches_f64(which, mis):
    js, ts = _scenes(which, "f64")
    o, d = (x.astype(np.float64) for x in rays(B, 5))
    g = np.random.default_rng(1)
    cam_u = g.uniform(size=(B, DEPTH, jbdpt.NT))
    ls_u = g.uniform(size=(B, jbdpt.NLS))
    light_u = g.uniform(size=(B, DEPTH - 1, jbdpt.NT))
    rad_j, st_j = jbdpt.bdpt_radiance(
        js, jnp.asarray(o), jnp.asarray(d), DEPTH, jpt.array_uniforms_fn(jnp.asarray(cam_u)),
        jnp.asarray(ls_u), jpt.array_uniforms_fn(jnp.asarray(light_u)), mis=mis)
    rad_t, st_t = tbdpt.bdpt_radiance(
        ts, torch.from_numpy(o), torch.from_numpy(d), DEPTH,
        tpt.array_uniforms_fn(torch.from_numpy(cam_u)), torch.from_numpy(ls_u),
        tpt.array_uniforms_fn(torch.from_numpy(light_u)), mis=mis)
    assert rad_t.dtype == torch.float64
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=1e-10, atol=1e-10)
    for name in st_j._fields:
        assert int(getattr(st_t, name)) == int(getattr(st_j, name)), name
    assert int(st_t.shadow_rays) > 0


# --------------------------------------------- f32 kernel plain versions


def _assert_agree(got, want, T, hits=None):
    """got: a plain version's outputs; want: the Pallas kernel's; hits:
    the tri_hits to hold the plain version to (default: the kernel's)."""
    g = np.stack([t.numpy() for t in got[:3]], -1)
    w = np.stack([np.asarray(x) for x in want[:3]], -1)
    assert np.isfinite(g).all()
    ok = np.isclose(g, w, rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= MIN_FRAC, np.nonzero(~ok)[0]
    rays_g, rays_w = int(got[3]), int(want[3])
    assert rays_g == rays_w > 0
    extra_g = [int(x) for x in got[5]]
    extra_w = [int(x) for x in np.asarray(want[5])]
    assert extra_g[:2] == extra_w[:2] == [0, 0]
    assert extra_g[3] == (extra_w[3] if hits is None else hits) > 0  # tri hits
    cand_g, cand_w = (extra_g[2] - T * rays_g) // T, (extra_w[2] - T * rays_w) // T
    assert (extra_g[2] - T * rays_g) % T == 0
    assert abs(cand_g - cand_w) <= COUNT_REL * cand_w
    shadow_g, shadow_w = int(got[4]), int(want[4])
    assert 0 < shadow_g <= cand_g
    assert abs(shadow_g - shadow_w) <= COUNT_REL * shadow_w


def _lane_ids():
    ids = np.arange(B, dtype=np.int32) * 3 + 1000
    ids[::17] = -1  # inactive lanes contribute nothing and count nothing
    return ids


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
@pytest.mark.parametrize("mode", ["buffer", "rng"])
def test_plain_megakernel_matches_pallas(mode, mis):
    js, ts = _scenes("cornell" if mode == "rng" else "mixed", "f32")
    o, d = rays(B, 40 + int(mis))
    ids = _lane_ids()
    u = (np.random.default_rng(2).uniform(size=(jbk.n_uniform_slots(DEPTH), B))
         .astype(np.float32) if mode == "buffer" else None)
    want = jbk.bdpt_megakernel(js, jv3.from_array(jnp.asarray(o)),
                               jv3.from_array(jnp.asarray(d)), jnp.asarray(ids),
                               jax.random.PRNGKey(4), DEPTH,
                               uniforms=None if u is None else jnp.asarray(u),
                               interpret=True, mis=mis)
    calls = tbk.bdpt_megakernel_plain.calls
    got = tbk.bdpt_megakernel(ts, tv3.from_array(torch.from_numpy(o)),
                              tv3.from_array(torch.from_numpy(d)), torch.from_numpy(ids),
                              rng.prng_key(4), DEPTH,
                              uniforms=None if u is None else torch.from_numpy(u), mis=mis)
    assert tbk.bdpt_megakernel_plain.calls == calls + 1  # CPU tensors: plain version
    hits = None
    if u is not None:
        # On the mixed scene a grazing ray (lane 45, ray id 1135; with MIS
        # also lane 21, id 1063) hits the dielectric box in bpt_tpu's jnp
        # wavefront and misses it in its Pallas kernel, or the reverse.
        # The plain version is the jnp wavefront's port: its hit count is
        # held to the wavefront's, exactly.
        act = ids >= 0
        rows = [u[k, act] for k in range(u.shape[0])]
        _, st = jbdpt.bdpt_radiance(
            js, jnp.asarray(o[act]), jnp.asarray(d[act]), DEPTH,
            lambda b, n: [jnp.asarray(r) for r in rows[b * 5:b * 5 + n]],
            [jnp.asarray(r) for r in rows[DEPTH * 5:DEPTH * 5 + 5]],
            lambda b, n: [jnp.asarray(r) for r in rows[DEPTH * 5 + 5 + b * 5:][:n]],
            mis=mis)
        hits = int(st.tri_hits)
        assert int(st.rays_traced) == int(got[3])
        assert 0 < abs(hits - int(np.asarray(want[5])[3])) <= 2
    _assert_agree(got, want, ts.num_tris, hits)
    assert all(float(c[::17].abs().max()) == 0.0 for c in got[:3])


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
def test_plain_megakernel_pixels_matches_pallas(mis):
    js, ts = _scenes("cornell", "f32")
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
    want = jbk.bdpt_megakernel_pixels(js, jnp.asarray(i), jnp.asarray(j), jnp.asarray(pix),
                                      jk.camera_table(ccj), jax.random.PRNGKey(7), 3, S,
                                      interpret=True, mis=mis)
    calls = tbk.bdpt_megakernel_pixels_plain.calls
    got = tbk.bdpt_megakernel_pixels(ts, torch.from_numpy(i), torch.from_numpy(j),
                                     torch.from_numpy(pix), tk.camera_table(cct),
                                     rng.prng_key(7), 3, S, mis=mis)
    assert tbk.bdpt_megakernel_pixels_plain.calls == calls + 1
    # 4 strata per lane: a flipped pair in any of them moves the pixel
    g = np.stack([t.numpy() for t in got[:3]], -1)
    w = np.stack([np.asarray(x) for x in want[:3]], -1)
    assert np.isclose(g, w, rtol=RTOL, atol=ATOL).all(-1).mean() >= 0.9
    assert np.allclose(g.sum(0), w.sum(0), rtol=0.02)
    assert int(got[3]) == int(want[3]) > 0
    assert int(got[5][3]) == int(np.asarray(want[5])[3])
    assert abs(int(got[4]) - int(want[4])) <= COUNT_REL * int(want[4])
    assert float(got[0][-3:].abs().max()) == 0.0


def test_mis_weights_only_damp():
    """Per lane, bdpt-mis never exceeds the unweighted all-pairs sum on the
    same draws (test_pallas_kernels.py's check, on the plain version)."""
    _, ts = _scenes("mixed", "f32")
    o, d = rays(B, 50)
    ids = torch.arange(B, dtype=torch.int32)
    u = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(rng.n_uniform_slots(DEPTH), B)).astype(np.float32))
    args = (ts, tv3.from_array(torch.from_numpy(o)), tv3.from_array(torch.from_numpy(d)),
            ids, rng.prng_key(0), DEPTH)
    plain = torch.stack(tbk.bdpt_megakernel_plain(*args, uniforms=u)[:3], -1)
    mis = torch.stack(tbk.bdpt_megakernel_plain(*args, uniforms=u, mis=True)[:3], -1)
    assert bool((mis <= plain + 1e-5).all())
    assert float(mis.sum()) < float(plain.sum())


@pytest.mark.parametrize("depth", [0, tbk.MAX_DEPTH + 1])
def test_depth_outside_kernel_bound_raises(depth):
    ts = tpresets.cornell_box(device="cpu")
    o = tv3.Vec3(*(torch.zeros(4) for _ in range(3)))
    with pytest.raises(ValueError, match="depth"):
        tbk.bdpt_megakernel(ts, o, o, torch.arange(4), rng.prng_key(0), depth)
