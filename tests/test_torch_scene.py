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
from bpt_tpu_torch.models import camera as tcam
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
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


@pytest.mark.parametrize("feature", ["texture", "light_texture", "iso_texture", "volume"])
def test_unported_builder_features_raise(feature):
    b = tbuilder.SceneBuilder()
    MS = tbuilder.MaterialSpec
    calls = {
        "texture": lambda: MS.lambertian((0.5, 0.5, 0.5), texture=object()),
        "light_texture": lambda: MS.diffuse_light((1, 1, 1), texture=object()),
        "iso_texture": lambda: MS.isotropic((0.5, 0.5, 0.5), texture=object()),
        "volume": lambda: b.add_volume_box((0, 0, 0), (1, 1, 1), 0.01),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        calls[feature]()
