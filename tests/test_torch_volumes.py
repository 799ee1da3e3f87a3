"""bpt_tpu_torch's constant-density volumes against bpt_tpu: the builder's
and the loader's volume arrays, the loader's refusals, the free-flight
override of ``ops.soa`` (``volume_interaction`` / ``apply_volumes``), the
kernels' volume tables and caps, and the streams' volume slots.

Tolerances: scene arrays exact; the override at f64 on 2,048 rays into the
smoke boxes with injected draws: hit and material exact, t and the hit
point within 1e-12 (ROADMAP "Numerics"); stream rows and keys bit-equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.models import pt as jpt
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.ops.pallas import bdpt_kernel as jbk
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import loader as jloader
from bpt_tpu.scene import textures as jtex
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import loader as tloader
from bpt_tpu_torch.scene import textures as ttex
from torch_parity import assert_scene_equal, smoke_scene, to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_YAML = os.path.join(ROOT, "scenes", "cornell_smoke.yaml")


def _volume_builder(builder_mod, tex_mod, kind):
    """A floor quad and one volume of each kind: a rotated and translated
    box, a sphere, a textured box beside an untextured sphere."""
    MS = builder_mod.MaterialSpec
    b = builder_mod.SceneBuilder()
    b.add_quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), MS.lambertian((0.5, 0.5, 0.5)))
    if kind == "box":
        b.add_volume_box((-1, 0.01, -1), (1, 2, 1.5), 0.3, albedo=(0.2, 0.4, 0.6),
                         rotate_y_degrees=27.0, translate=(0.5, 0.0, -0.25))
    elif kind == "sphere":
        b.add_volume_sphere((0, 1, 0), 0.8, 0.05, albedo=(0.9, 0.9, 0.9))
    else:
        b.add_volume_box((-1, 0.01, -1), (1, 2, 1), 0.2,
                         texture=tex_mod.TextureSpec.checker(0.5, (0.9, 0.2, 0.1),
                                                             (0.1, 0.3, 0.9)))
        b.add_volume_sphere((2, 1, 2), 0.5, 0.4, albedo=(0.3, 0.3, 0.3))
    return b


@pytest.mark.parametrize("kind", ["box", "sphere", "textured"])
def test_builder_volume_arrays_match_bpt_tpu(kind):
    """Every array of the scene, the vol_* ones included, equal to
    bpt_tpu's builder's."""
    got = _volume_builder(tbuilder, ttex, kind).build(device="cpu")
    want = _volume_builder(jbuilder, jtex, kind).build(dtype=jnp.float32)
    assert got.num_volumes == (2 if kind == "textured" else 1)
    assert got.has_textures == (kind == "textured") and got.has_iso_mats
    assert got.num_tris == 2 and got.vol_tri_vol.dtype == torch.int32
    assert_scene_equal(got, want)
    # the boundary soup stays out of the surface arrays; grouped by owner
    assert np.all(np.diff(got.vol_tri_vol.numpy()) >= 0)


def test_scene_without_volumes_keeps_one_zero_row():
    got = tbuilder.SceneBuilder()
    got.add_quad((0, 0, 0), (1, 0, 0), (0, 0, 1), tbuilder.MaterialSpec.lambertian((1, 1, 1)))
    s = got.build(device="cpu")
    assert s.num_volumes == 0
    assert tuple(s.vol_v0.shape) == (1, 3) and not bool(s.vol_v0.any())
    assert s.vol_neg_inv_density.tolist() == [-1.0] and s.vol_mat.tolist() == [0]


def _yaml(tmp_path, body):
    p = tmp_path / "v.yaml"
    p.write_text("camera: {resolution: [8, 8]}\nsurfaces:\n"
                 "  - type: TriMesh\n    material: {type: lambertian, albedo: [1, 1, 1]}\n"
                 "    data: {vertices: [0, 0, 0, 1, 0, 0, 0, 0, 1]}\n" + body)
    return str(p)


def test_loader_volume_sphere_and_texture_match_bpt_tpu(tmp_path, capsys):
    """volume_sphere, a translated volume_box with 0-255 albedo and a
    checker texture, as bpt_tpu's loader builds them."""
    path = _yaml(tmp_path, "  - type: volume_sphere\n    density: 0.5\n"
                           "    data: {center: [0, 1, 0], radius: 0.5}\n"
                           "  - type: volume_box\n    density: 2\n    albedo: [128, 64, 255]\n"
                           "    texture: {type: checker, scale: 0.3, even: [1, 0, 0], "
                           "odd: [0, 0, 1]}\n"
                           "    data: {min: [0, 0, 0], max: [1, 1, 1], rotate_y: 10, "
                           "translate: [2, 0, 0]}\n")
    got = tloader.load_scene_from_yaml(path, device="cpu")
    want = jloader.load_scene_from_yaml(path, dtype=jnp.float32)
    assert got.scene.num_volumes == 2 and got.scene.has_textures
    assert int(got.scene.vol_v0.shape[0]) == 960 + 12
    assert_scene_equal(got.scene, want.scene)
    assert "Triangles: 1" in capsys.readouterr().out


@pytest.mark.parametrize("body, match", [
    ("  - type: volume_box\n    density: 0.1\n", "missing data"),
    ("  - type: volume_box\n    data: {min: [0, 0, 0], max: [1, 1, 1]}\n", "density"),
    ("  - type: volume_box\n    density: -1\n    data: {min: [0, 0, 0], max: [1, 1, 1]}\n",
     "density"),
    ("  - type: volume_box\n    density: 1\n    data: {min: [0, 0, 0], max: [1, 0, 1]}\n",
     "extents"),
    ("  - type: volume_sphere\n    density: 1\n    data: {center: [0, 0, 0]}\n", "radius"),
])
def test_loader_volume_errors_match_bpt_tpu(tmp_path, body, match):
    """The loader's ValueErrors, each the one bpt_tpu raises."""
    path = _yaml(tmp_path, body)
    with pytest.raises(ValueError, match=match) as got:
        tloader.load_scene_from_yaml(path, device="cpu", verbose=False)
    with pytest.raises(ValueError) as want:
        jloader.load_scene_from_yaml(path, verbose=False)
    assert str(got.value) == str(want.value)


def _smoke_rays(B, seed):
    """Rays from the cornell camera through random points of the box, a
    few from inside the smoke boxes (f64)."""
    g = np.random.default_rng(seed)
    o = np.tile([[278.0, 278.0, -800.0]], (B, 1))
    o[: B // 8] = g.uniform([150, 20, 100], [250, 150, 200], (B // 8, 3))
    d = g.uniform(50, 500, (B, 3)) - o
    return o, d


def test_apply_volumes_matches_bpt_tpu_f64():
    """soa.volume_interaction / apply_volumes after the closest surface hit
    on 2,048 rays into the smoke boxes, injected draws, f64: hit and
    material exact, t and the point within 1e-12."""
    js = smoke_scene(jbuilder, dtype=jnp.float64)
    ts = smoke_scene(tbuilder, device="cpu", dtype=torch.float64)
    assert ts.num_volumes == 2
    B = 2048
    o, d = _smoke_rays(B, 5)
    u = np.random.default_rng(6).uniform(size=(2, B))
    active = np.random.default_rng(7).uniform(size=B) < 0.9
    ov, dv = Vec3(*torch.from_numpy(o).unbind(1)), Vec3(*torch.from_numpy(d).unbind(1))
    jo, jd = jv3.from_array(jnp.asarray(o)), jv3.from_array(jnp.asarray(d))
    act = torch.from_numpy(active)
    th = tsoa.closest_hit(ts, ov, dv, T_MIN, torch.inf, mask=act)
    jh = jsoa.closest_hit(js, jo, jd, T_MIN, jnp.inf, mask=jnp.asarray(active))
    got, got_vmat = tsoa.apply_volumes(ts, ov, dv, tsoa.complete_hit(ts, ov, dv, th),
                                       list(torch.from_numpy(u)), act)
    want = jsoa.apply_volumes(js, jo, jd, jsoa.complete_hit(js, jo, jd, jh),
                              list(jnp.asarray(u)), jnp.asarray(active))
    vhit, _, vmat = tsoa.volume_interaction(
        ts, ov, dv, T_MIN, torch.where(th.hit, th.t, torch.inf), list(torch.from_numpy(u)), act)
    assert 100 < int(vhit.sum()) < B - 100 and set(vmat[vhit].tolist()) == {6, 7}
    assert torch.equal(got_vmat, torch.where(vhit, vmat, -1))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    np.testing.assert_array_equal(got.front_face.numpy(), np.asarray(want.front_face))
    h = got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(want.t)[h], rtol=1e-12, atol=0)
    for a, b in zip((*got.p, *got.normal, got.u, got.v), (*want.p, *want.normal, want.u, want.v)):
        np.testing.assert_allclose(a.numpy()[h], np.asarray(b)[h], rtol=1e-12, atol=1e-12)


def test_vol_tables_match_bpt_tpu():
    """pack_vol_tables and meta[7] equal to bpt_tpu's _pack_vol_tables and
    meta; the caps as bpt_tpu's: MAX_VOLS volumes, MAX_VOL_TRIS boundary
    triangles (a volume_sphere's 960 go to the stratum loop)."""
    js = smoke_scene(jbuilder, dtype=jnp.float32)
    ts = smoke_scene(tbuilder, device="cpu")
    vol, volm = tk.pack_vol_tables(ts)
    jvol, jvolm = jk._pack_vol_tables(js)
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jvol))
    np.testing.assert_array_equal(volm.numpy(), np.asarray(jvolm))
    assert tk._pack_tables(ts)[0].tolist()[6:] == [2, 24]
    assert (tk.MAX_VOLS, tk.MAX_VOL_TRIS) == (jk.MAX_VOLS, jk.MAX_VOL_TRIS)
    for integrator in tk.INTEGRATORS:
        assert tk.megakernel_reject_reason(ts, integrator) == ""
    sphere = _volume_builder(tbuilder, ttex, "sphere").build(device="cpu")
    assert "MAX_VOL_TRIS=64" in tk.shade_reject_reason(sphere)
    b = _volume_builder(tbuilder, ttex, "box")
    for k in range(4):
        b.add_volume_box((k, 3, 0), (k + 0.5, 3.5, 0.5), 0.1)
    assert "5 volumes > MAX_VOLS=4" in tk.shade_reject_reason(b.build(device="cpu"))


# ------------------------------------------------------------- the streams


@pytest.mark.parametrize("depth, n_vols", [(1, 2), (4, 1), (5, 4)])
def test_bdpt_volume_slots_and_subkeys_bitequal(depth, n_vols):
    assert rng.n_uniform_slots(depth, n_vols) == jbk.n_uniform_slots(depth, n_vols)
    key = jax.random.PRNGKey(17)
    assert ([int(x) for x in np.asarray(jbk._subkeys_bdpt(key, depth, n_vols))]
            == rng.subkeys_bdpt(rng.prng_key(17), depth, n_vols))
    assert ([int(x) for x in np.asarray(jbk._subkeys_bdpt_raygen(key, depth, n_vols))]
            == rng.subkeys_bdpt_raygen(rng.prng_key(17), depth, n_vols))


def test_bdpt_volume_stream_rows_bitequal():
    """bdpt_kernel_stream_uniforms_fn with volumes: every row is word x0 of
    threefry(bpt_tpu's key of the slot, (rid, 0)), the free-flight slots
    last in each trace bounce."""
    depth, nv = 3, 2
    ids = np.random.default_rng(8).integers(0, 2**31 - 1, 200).astype(np.int32)
    keys = np.asarray(jbk._subkeys_bdpt(jax.random.PRNGKey(3), depth, nv))
    cam_fn, ls_rows, light_fn = rng.bdpt_kernel_stream_uniforms_fn(
        rng.prng_key(3), torch.from_numpy(ids), depth, torch.float32, nv)
    ntv = 5 + nv
    pairs = ([(b * ntv + s, cam_fn(b, ntv)[s]) for b in range(depth) for s in range(ntv)]
             + [(depth * ntv + s, ls_rows[s]) for s in range(5)]
             + [(depth * ntv + 5 + b * ntv + s, light_fn(b, ntv)[s])
                for b in range(depth - 1) for s in range(ntv)])
    assert len(pairs) == jbk.n_uniform_slots(depth, nv)
    ru = jnp.asarray(ids).astype(jnp.uint32)
    for slot, row in pairs:
        bits, _ = jk._threefry2x32(jnp.uint32(keys[2 * slot]), jnp.uint32(keys[2 * slot + 1]),
                                   ru, jnp.zeros_like(ru))
        want = np.asarray(jk._bits_to_unit_float(bits))
        np.testing.assert_array_equal(row.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_vols", [1, 4])
def test_pt_volume_stream_rows_bitequal(n_vols):
    """kernel_stream_uniforms_fn with n_vols: the surface pairs and the
    single-draw volume slots NU..NU+V-1 equal to bpt_tpu's, bit for bit."""
    ids = np.random.default_rng(9).integers(0, 2**31 - 1, 256).astype(np.int32)
    n = tpt.NU + n_vols
    jfn = jpt.kernel_stream_uniforms_fn(jax.random.PRNGKey(11), jnp.asarray(ids),
                                        jnp.float32, n_vols)
    tfn = tpt.kernel_stream_uniforms_fn(rng.prng_key(11), torch.from_numpy(ids),
                                        torch.float32, n_vols)
    for bounce in (0, 3):
        for a, b in zip(tfn(bounce, n), jfn(bounce, n), strict=True):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b).view(np.uint32))
    assert rng.subkeys(rng.prng_key(11), n) == [
        int(x) for x in np.asarray(jk._subkeys(jax.random.PRNGKey(11), n))]


def test_port_scene_round_trip_carries_volumes():
    """scene_from_numpy of bpt_tpu's arrays carries the volume fields."""
    js = smoke_scene(jbuilder, dtype=jnp.float32)
    ts = to_port(js)
    assert ts.num_volumes == 2 and tuple(ts.vol_v0.shape) == (24, 3)
    np.testing.assert_array_equal(ts.vol_mat.numpy(), np.asarray(js.vol_mat))
