"""bpt_tpu_torch's scene side for YAML/OBJ scenes against bpt_tpu: the OBJ
parser, the BVH build, the builder's node arrays,
the YAML loader (camera and every scene array, exactly) and the scene
factories' device default."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import bvh as jbvh
from bpt_tpu.scene import loader as jloader
from bpt_tpu.scene import obj as jobj
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import bvh as tbvh
from bpt_tpu_torch.scene import loader as tloader
from bpt_tpu_torch.scene import obj as tobj
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.scene.types import scene_from_numpy, scene_to_numpy
from torch_parity import assert_scene_equal, big_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")
GLASS_OBJ = ["glass", "water", "ice1", "ice2", "floor", "backdrop"]


@pytest.mark.parametrize("path", [f"glass/data/{n}.obj" for n in GLASS_OBJ]
                         + ["coffee/data/Plastic_Black.obj"])
def test_parse_obj_matches_bpt_tpu(path):
    full = os.path.join(SCENES, path)
    got = tobj.parse_obj(full)
    assert got and got == jobj.parse_obj(full, use_native=False)


def test_parse_obj_faces_and_junk(tmp_path):
    """Fan triangulation, v/vt/vn tokens, negative indices, malformed
    tokens and short faces, as the reference parser takes them."""
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv bad 1 2\nvt 0 0\n"
                 "f 1/1/1 2//1 3 4\nf -1 -2 -3\nf 1 x 2 3\nf 1 2\n# c\n\n")
    got = tobj.parse_obj(str(p))
    assert len(got) == 4
    assert got == jobj.parse_obj(str(p), use_native=False)


def _glass_bounds():
    tris = [t for n in GLASS_OBJ
            for t in tobj.parse_obj(os.path.join(SCENES, "glass", "data", n + ".obj"))]
    v = np.asarray(tris, np.float64)
    return v.min(axis=1), v.max(axis=1)


@pytest.mark.parametrize("which", ["big", "glass"])
def test_bvh_and_cluster_splits_match_bpt_tpu(which):
    if which == "big":
        port = big_scene(tbuilder, device="cpu")
        jscene = big_scene(jbuilder, dtype=jnp.float32)
        assert port.num_tris == 964 and port.use_bvh
        assert_scene_equal(port, jscene)  # node arrays and triangle order
    else:
        lo, hi = _glass_bounds()
        tree = tbvh.build_bvh(lo, hi)
        want = jbvh.build_bvh(lo, hi, use_native=False)
        assert set(tree) == set(want)
        for k in tree:
            np.testing.assert_array_equal(tree[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["cornell_box", "glass/glass_standin",
                                  "coffee/coffee_standin"])
def test_loader_matches_bpt_tpu(name, capsys):
    path = os.path.join(SCENES, name + ".yaml")
    got = tloader.load_scene_from_yaml(path, device="cpu")
    want = jloader.load_scene_from_yaml(path, dtype=jnp.float32)
    cam = dataclasses.asdict(got.camera)
    assert cam == {k: getattr(want.camera, k) for k in cam}
    assert not want.camera.ref_vis  # bpt_tpu's only extra field, off
    out = capsys.readouterr().out
    assert out.count(f"Triangles: {got.scene.num_tris}") == 2
    assert_scene_equal(got.scene, want.scene)


@pytest.mark.parametrize("name", ["earth", "cornell_smoke"])
def test_loader_refuses_unported_features(name, capsys):
    """The textured earth.yaml and the volume scene cornell_smoke.yaml,
    each refused until its feature was ported, load equal to bpt_tpu's:
    the texture table, tex_id and tri_uv of the one, the volume arrays of
    the other (two boxes, 24 boundary triangles out of the surface
    arrays)."""
    path = os.path.join(SCENES, name + ".yaml")
    if name == "cornell_smoke":
        got = tloader.load_scene_from_yaml(path, device="cpu")
        want = jloader.load_scene_from_yaml(path, dtype=jnp.float32)
        assert got.scene.num_volumes == 2 and got.scene.num_tris == 12
        assert tuple(got.scene.vol_v0.shape) == (24, 3)
        assert dataclasses.asdict(got.camera) == {
            k: getattr(want.camera, k) for k in dataclasses.asdict(got.camera)}
        assert_scene_equal(got.scene, want.scene)
        assert "Triangles: 12" in capsys.readouterr().out
        return
    got = tloader.load_scene_from_yaml(path, device="cpu")
    want = jloader.load_scene_from_yaml(path, dtype=jnp.float32)
    assert got.scene.has_textures and got.scene.num_tris == 964
    assert tuple(got.scene.textures.images.shape) == (1, 512, 1024, 3)
    assert got.scene.materials.tex_id.tolist() == [0, 1, -1]
    assert_scene_equal(got.scene, want.scene)


def test_build_material_coercions_match_bpt_tpu():
    """Schema types, synonyms, the 0-255 autoscale, the light exemption,
    the legacy PBR mapping and junk values."""
    nodes = [
        {"type": "lambertian", "color": [255, 97, 3]},
        {"type": "lambertian", "albedo": [0.2, 0.3, 0.4]},
        {"type": "metal", "base_colour": [170, 170, 170], "roughness": "0.3"},
        {"type": "metal", "color": [1, 1, 1], "roughness": 7},
        {"type": "glass", "ior": -2},
        {"type": "dielectric", "ior": "1.33"},
        {"type": "light", "emission": [245, 245, 245]},
        {"type": "diffuse_light", "emission": [1, 2]},
        {"type": "bogus", "base_color": [0.5, 0.5, 0.5], "metallic": 0.9},
        {"emission": [500, 100, 0]},
        {"transmission": 0.5, "ior": 1.4},
        {"spec_trans": 1, "ior": 0},
        {"base_color": [300, 2, 2]},
        {"base_color": "junk", "roughness": True},
    ]
    textured = [
        {"type": "lambertian", "texture": {"type": "checker"}},
        {"type": "lambertian", "texture": {"type": "checker", "scale": "0.5",
                                           "even": [255, 0, 0], "odd": "junk"}},
        {"type": "light", "emission": [4, 4, 4], "texture": {"type": "noise"}},
        {"emission": [4, 4, 4], "texture": {"type": "noise", "scale": 3}},
        {"base_color": [0.2, 0.2, 0.2], "texture": {"type": "image", "file": "a.png"}},
        {"type": "metal", "texture": {"type": "checker"}},
        {"type": "lambertian", "texture": {"type": "image"}},
        {"type": "lambertian", "texture": {"type": "bogus"}},
    ]
    for node in nodes + textured:
        got = tloader.build_material(node, "/scenes")
        want = jloader.build_material(node, "/scenes")
        assert (got.mtype, got.albedo, got.fuzz, got.ior) == (
            want.mtype, want.albedo, want.fuzz, want.ior), node
        assert (got.texture is None) == (want.texture is None), node
        if got.texture is not None:  # the same texture, image path joined alike
            assert dataclasses.asdict(got.texture) == dataclasses.asdict(want.texture), node
    got = tloader.load_materials({"a": textured[0], "b": "junk"})
    assert list(got) == ["a"] and got["a"].texture.kind == 1


@pytest.mark.parametrize("factory", ["build", "cornell_box", "scene_from_numpy",
                                     "load_scene_from_yaml"])
def test_scene_factories_default_to_cuda(factory):
    """Entry points run on the card unless asked for the CPU; without a
    card the default raises, it never falls back."""
    arrays, meta = scene_to_numpy(tpresets.cornell_box(device="cpu"))
    make = {
        "build": lambda: tpresets.cornell_box_builder().build(),
        "cornell_box": tpresets.cornell_box,
        "scene_from_numpy": lambda: scene_from_numpy(arrays, meta),
        "load_scene_from_yaml": lambda: tloader.load_scene_from_yaml(
            os.path.join(SCENES, "cornell_box.yaml"), verbose=False).scene,
    }[factory]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
