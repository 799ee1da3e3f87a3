"""bpt_tpu_torch scene side against bpt_tpu: builder, presets, the
scene_from_numpy carry-over, the kernel tables and the camera."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import camera as jcam
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import presets as jpresets
from bpt_tpu.scene import textures as jtex
from bpt_tpu_torch.models import camera as tcam
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.scene import textures as ttex
from bpt_tpu_torch.scene.types import scene_from_numpy, scene_to_numpy
from torch_parity import big_scene, mixed_scene, to_port

DT = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def _assert_scene_equal(port, jscene):
    """Every field the port carries equals bpt_tpu's, exactly."""
    ref = to_port(jscene, dtype=port.dtype)
    arrays, meta = scene_to_numpy(port)
    ref_arrays, ref_meta = scene_to_numpy(ref)
    assert meta == ref_meta
    for name, a in arrays.items():
        assert a.dtype == ref_arrays[name].dtype, name
        np.testing.assert_array_equal(a, ref_arrays[name], err_msg=name)
    # and the carry-over itself is exact (no rounding through to_port)
    np.testing.assert_array_equal(arrays["v0"], np.asarray(jscene.v0))
    np.testing.assert_array_equal(arrays["mat_id"], np.asarray(jscene.mat_id))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_cornell_box_equals_bpt_tpu(dt):
    jdt, tdt = DT[dt]
    _assert_scene_equal(tpresets.cornell_box(device="cpu", dtype=tdt),
                        jpresets.cornell_box(dtype=jdt))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_mixed_material_scene_equals_bpt_tpu(dt):
    jdt, tdt = DT[dt]
    port = mixed_scene(tbuilder, tpresets, device="cpu", dtype=tdt)
    assert port.has_delta_mats and port.has_iso_mats
    _assert_scene_equal(port, mixed_scene(jbuilder, jpresets, dtype=jdt))


def test_scene_from_numpy_roundtrip():
    scene = mixed_scene(tbuilder, tpresets, device="cpu")
    arrays, meta = scene_to_numpy(scene)
    back = scene_from_numpy(arrays, meta, device="cpu")
    a2, m2 = scene_to_numpy(back)
    assert m2 == meta
    for name in arrays:
        np.testing.assert_array_equal(a2[name], arrays[name], err_msg=name)
    with pytest.raises(KeyError):
        scene_from_numpy({k: v for k, v in arrays.items() if k != "v0"}, meta, device="cpu")


@pytest.mark.parametrize("which", ["cornell", "mixed", "big"])
def test_pack_tables_equal(which):
    """The megakernels' tables; on the 964-triangle scene, their walk mode
    (bpt_tpu's clustered mode) gets one zero triangle row."""
    if which == "cornell":
        js, ts = jpresets.cornell_box(), tpresets.cornell_box(device="cpu")
    elif which == "big":
        js, ts = big_scene(jbuilder), big_scene(tbuilder, device="cpu")
        assert jk.use_clusters(js) and tk.use_walk(ts)
    else:
        js = mixed_scene(jbuilder, jpresets)
        ts = mixed_scene(tbuilder, tpresets, device="cpu")
    assert tk.megakernel_reject_reason(ts) == jk.megakernel_reject_reason(js) == ""
    for w, g in zip(jk._pack_tables(js), tk._pack_tables(ts)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("spp", [1, 4, 16])
def test_camera_table_equal(spp):
    cfg_j = dataclasses.replace(jpresets.cornell_box_camera(), image_width=37,
                                samples_per_pixel=spp)
    cfg_t = dataclasses.replace(tpresets.cornell_box_camera(), image_width=37,
                                samples_per_pixel=spp)
    want = jk.camera_table(jcam.camera_constants(cfg_j, jnp.float32))
    got = tk.camera_table(tcam.camera_constants(cfg_t, torch.float32))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("defocus", [0.0, 2.5])
def test_generate_rays_matches(defocus):
    kw = dict(image_width=16, samples_per_pixel=4, defocus_angle=defocus,
              focus_dist=700.0)
    ccj = jcam.camera_constants(
        dataclasses.replace(jpresets.cornell_box_camera(), **kw), jnp.float64)
    cct = tcam.camera_constants(
        dataclasses.replace(tpresets.cornell_box_camera(), **kw), torch.float64)
    assert cct.defocus == ccj.defocus == (defocus > 0)
    rng = np.random.default_rng(2)
    n = 200
    i, j = rng.integers(0, 16, n).astype(np.float64), rng.integers(0, 16, n).astype(np.float64)
    si, sj = rng.integers(0, 2, n).astype(np.float64), rng.integers(0, 2, n).astype(np.float64)
    u = rng.uniform(size=(n, 4))
    oj, dj = jcam.generate_rays(ccj, *(jnp.asarray(x) for x in (i, j, si, sj, u)))
    ot, dt_ = tcam.generate_rays(cct, *(torch.from_numpy(x) for x in (i, j, si, sj, u)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-12, atol=1e-9)


def _textured_spec(feature, builder_mod, tex_mod):
    MS, TS = builder_mod.MaterialSpec, tex_mod.TextureSpec
    return {
        "texture": lambda: MS.lambertian((0.5, 0.5, 0.5),
                                         texture=TS.checker(0.3, (1, 0, 0), (0, 0, 1))),
        "light_texture": lambda: MS.diffuse_light((1, 1, 1), texture=TS.noise(2.0)),
        "iso_texture": lambda: MS.isotropic((0.5, 0.5, 0.5),
                                            texture=TS.solid((0.2, 0.3, 0.4))),
    }[feature]()


@pytest.mark.parametrize("feature", ["texture", "light_texture", "iso_texture", "volume"])
def test_unported_builder_features_raise(feature):
    """Each feature raised until it was ported: a textured lambertian,
    light or isotropic spec builds the texture table and tex_id bpt_tpu's
    builder does; a volume box builds bpt_tpu's volume arrays (the
    boundary soup outside the surface arrays, -1/density, the isotropic
    phase material)."""
    if feature == "volume":
        scenes = []
        for builder_mod, kw in ((tbuilder, dict(device="cpu")),
                                (jbuilder, dict(dtype=jnp.float32))):
            b = builder_mod.SceneBuilder()
            b.add_quad((0, 0, 0), (1, 0, 0), (0, 0, 1),
                       builder_mod.MaterialSpec.lambertian((0.7,) * 3))
            assert b.add_volume_box((0, 0, 0), (1, 1, 1), 0.01, albedo=(0.5, 0.6, 0.7)) == 0
            scenes.append(b.build(**kw))
        got, want = scenes
        assert got.num_volumes == 1 and got.num_tris == 2 and got.has_iso_mats
        ref = to_port(want)
        for name in ("vol_v0", "vol_e1", "vol_e2", "vol_tri_vol", "vol_neg_inv_density",
                     "vol_mat"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert torch.equal(got.materials.albedo, ref.materials.albedo)
        return
    scenes = []
    for builder_mod, tex_mod, kw in ((tbuilder, ttex, dict(device="cpu")),
                                     (jbuilder, jtex, dict(dtype=jnp.float32))):
        b = builder_mod.SceneBuilder()
        b.add_quad((0, 0, 0), (1, 0, 0), (0, 0, 1), builder_mod.MaterialSpec.lambertian((0.7,) * 3))
        b.add_quad((0, 2, 0), (1, 0, 0), (0, 0, 1), _textured_spec(feature, builder_mod, tex_mod))
        scenes.append(b.build(**kw))
    got, want = scenes
    assert got.has_textures and got.materials.tex_id.tolist() == [-1, 0]
    assert got.has_noise == (feature == "light_texture")
    ref = to_port(want)
    for f in dataclasses.fields(got.textures):
        assert torch.equal(getattr(got.textures, f.name), getattr(ref.textures, f.name)), f.name
    assert torch.equal(got.materials.tex_id, ref.materials.tex_id)
