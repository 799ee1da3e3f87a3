"""bpt_tpu_torch's textures against bpt_tpu: the texture table and
``texture_value``, the builder's and the loader's textured scenes, the hit
record's UVs, PT's jnp estimator on a textured scene, and the CLI on
``scenes/earth.yaml``.  BDPT's estimators on a textured scene are in
``test_torch_textured_estimators.py``, ``pt_wave``'s textured mode and the
routes in ``test_torch_textured_wave.py``.

Tolerances: texture lookups of the solid, checker and image kinds exact
(each at one dtype: an image index is a float-to-int truncation), the noise
kind to 1e-12 at f64 and 1e-5 at f32; scenes exact; UVs and the PT
estimator's radiance to 1e-12 at f64, its counters exact."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.models import pt as jpt
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import loader as jloader
from bpt_tpu.scene import textures as jtex
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import loader as tloader
from bpt_tpu_torch.scene import textures as ttex
from torch_parity import assert_scene_equal, atlas, rays, textured_cornell_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EARTH = os.path.join(ROOT, "scenes", "earth.yaml")


def _specs(mod, image_path):
    TS = mod.TextureSpec
    return [TS.solid((0.2, 0.4, 0.6)), TS.checker(0.35, (0.9, 0.3, 0.2), (0.1, 0.8, 0.3)),
            TS.image(image_path), TS.noise(4.0), TS.image(image_path + ".missing")]


def _jtable(image_path, dtype):
    return jtex.build_texture_table(_specs(jtex, image_path), dtype=dtype)


def _ttable(image_path, dtype):
    return ttex.build_texture_table(_specs(ttex, image_path), dtype=dtype)


def test_build_texture_table_matches_bpt_tpu(tmp_path):
    """Every field equal, the perlin tables bit for bit, a missing image the
    1x1 magenta pixel."""
    path = atlas(tmp_path)
    want = _jtable(path, np.float32)
    got = _ttable(path, torch.float32)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(g, w, err_msg=f.name)
        assert g.dtype == (np.int64 if g.dtype.kind == "i" else np.float32), f.name
    assert got.images.shape == (2, 6, 8, 3)
    assert got.images[1, 0, 0].tolist() == [255.0, 0.0, 255.0]
    assert ttex._load_image(path + ".missing").shape == (1, 1, 3)


@pytest.mark.parametrize("kind", ["solid", "checker", "image", "noise"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_texture_value_matches_bpt_tpu(tmp_path, kind, dt):
    """Seeded points and UVs, the UVs past [0, 1] on both sides (clamped),
    through each kind; noise to 1e-12 at f64 (f32: 1e-5), the rest exact."""
    npdt, tdt = (np.float64, torch.float64) if dt == "f64" else (np.float32, torch.float32)
    path = atlas(tmp_path)
    k = ["solid", "checker", "image", "noise"].index(kind)
    g = np.random.default_rng(k)
    N = 4000
    p = (g.uniform(-5, 5, (N, 3)) + 0.0123).astype(npdt)
    u, v = (g.uniform(-0.2, 1.2, N).astype(npdt) for _ in range(2))
    tid = np.full(N, k, np.int64)
    tid[::7] = 4  # the magenta image
    want = jtex.texture_value(_jtable(path, npdt), jnp.asarray(tid), jnp.asarray(u),
                              jnp.asarray(v), jnp.asarray(p))
    got = ttex.texture_value(_ttable(path, tdt), torch.from_numpy(tid), torch.from_numpy(u),
                             torch.from_numpy(v), torch.from_numpy(p))
    assert got.dtype == tdt and got.shape == (N, 3)
    if kind == "noise":
        tol = 1e-12 if dt == "f64" else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
        assert np.ptp(got.numpy()) > 0.5
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # with_noise=False leaves the noise kind at its colour0 (zeros), as bpt_tpu's
    want0 = jtex.texture_value(_jtable(path, npdt), jnp.asarray(tid), jnp.asarray(u),
                               jnp.asarray(v), jnp.asarray(p), with_noise=False)
    got0 = ttex.texture_value(_ttable(path, tdt), torch.from_numpy(tid), torch.from_numpy(u),
                              torch.from_numpy(v), torch.from_numpy(p), with_noise=False)
    np.testing.assert_array_equal(got0.numpy(), np.asarray(want0))


def test_texture_value_takes_any_leading_shape(tmp_path):
    """[S, B] lanes, as BDPT's light vertices give them, equal the flat
    call."""
    path = atlas(tmp_path)
    tt = _ttable(path, torch.float64)
    g = np.random.default_rng(5)
    tid = torch.from_numpy(g.integers(0, 5, (3, 50)))
    u, v = (torch.from_numpy(g.uniform(size=(3, 50))) for _ in range(2))
    p = torch.from_numpy(g.uniform(-3, 3, (3, 50, 3)))
    got = ttex.texture_value(tt, tid, u, v, p)
    flat = ttex.texture_value(tt, tid.reshape(-1), u.reshape(-1), v.reshape(-1),
                              p.reshape(-1, 3))
    assert torch.equal(got.reshape(-1, 3), flat)


def _uv_builder(mod, tex_mod, image_path):
    MS, TS = mod.MaterialSpec, tex_mod.TextureSpec
    b = mod.SceneBuilder()
    img = MS.lambertian((0.5, 0.5, 0.5), texture=TS.image(image_path))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), img,
                   uvs=((0.1, 0.2), (0.9, 0.3), (0.4, 0.8)))
    b.add_triangle((0, 0, 1), (1, 0, 1), (0, 1, 1), img, uvs=((0, 1), (1, 1), (0, 0)),
                   rotate_y_degrees=30.0, translate=(2, 0, 0))
    b.add_uv_sphere((0, 3, 0), 1.5, img, lat_steps=5, lon_steps=7, rotate_y_degrees=20.0)
    b.add_quad((-4, 0, -4), (8, 0, 0), (0, 0, 8), MS.lambertian(
        (0.6, 0.6, 0.6), texture=TS.checker(0.5, (0.9, 0.9, 0.9), (0.1, 0.1, 0.1))))
    b.add_quad((-1, 6, -1), (2, 0, 0), (0, 0, 2),
               MS.diffuse_light((4, 4, 4), texture=TS.noise(2.0)))
    b.add_quad((3, 1, 3), (1, 0, 0), (0, 1, 0),
               MS.isotropic((0.5, 0.5, 0.5), texture=TS.solid((0.3, 0.2, 0.1))))
    return b


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_builder_uvs_and_texture_table_match_bpt_tpu(tmp_path, dt):
    """add_triangle(uvs=...), add_uv_sphere's spherical UVs (rotated), and
    the table and tex_id of textured lambertian, light and isotropic specs."""
    path = atlas(tmp_path)
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else (jnp.float32, torch.float32)
    port = _uv_builder(tbuilder, ttex, path).build(device="cpu", dtype=tdt)
    want = _uv_builder(jbuilder, jtex, path).build(dtype=jdt)
    assert port.has_textures and port.has_noise
    assert port.materials.tex_id.tolist() == [0, 1, 2, 3]
    assert not torch.equal(port.tri_uv[:, 0], port.tri_uv[:, 1])
    assert_scene_equal(port, want)


def _textured_yaml(tmp_path, image_path):
    p = tmp_path / "textured.yaml"
    p.write_text(f"""
camera: {{resolution: [8, 6], fov: 40, location: [0, 2, 9], look_at: [0, 1, 0]}}
materials:
  Checker:
    type: lambertian
    texture: {{type: checker, scale: 0.7, even: [200, 30, 30], odd: [0.1, 0.9, 0.2]}}
  Noise: {{type: lambertian, texture: {{type: noise, scale: 3}}}}
  Glow: {{emission: [9, 9, 9], texture: {{type: checker, scale: 0.5}}}}
  Plain: {{type: lambertian, color: [0.5, 0.5, 0.5], texture: {{type: bogus}}}}
surfaces:
  - type: Sphere
    material: {{type: lambertian, texture: {{type: image, file: {os.path.basename(image_path)}}}}}
    data: {{center: [0, 1, 0], radius: 1}}
  - type: mesh
    vertices: [[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]]
    triangles: [[0, 1, 2], [0, 2, 3]]
    material: Checker
  - type: TriMesh
    data: {{vertices: [2, 0, 0, 3, 0, 0, 2, 1, 0]}}
    material: {{type: light, emission: [3, 3, 3], texture: {{type: noise}}}}
  - type: mesh
    vertices: [[-2, 5, -2], [2, 5, -2], [2, 5, 2]]
    triangles: [[0, 2, 1]]
    material: Glow
  - type: mesh
    vertices: [[-3, 0, 2], [-2, 0, 2], [-3, 1, 2]]
    triangles: [[0, 1, 2]]
    material: Noise
  - type: mesh
    vertices: [[3, 0, 2], [4, 0, 2], [3, 1, 2]]
    triangles: [[0, 1, 2]]
    material: Plain
""")
    return str(p)


def test_textured_yaml_loads_equal_to_bpt_tpu(tmp_path, capsys):
    """A YAML with an image (relative to the YAML's directory), checker and
    noise texture on lambertians and lights, inline and named, and an
    unknown texture type (ignored); scenes/earth.yaml is
    test_torch_loader.py's."""
    path = _textured_yaml(tmp_path, atlas(tmp_path))
    got = tloader.load_scene_from_yaml(path, device="cpu")
    want = jloader.load_scene_from_yaml(path, dtype=jnp.float32)
    assert dataclasses.asdict(got.camera) == {
        k: getattr(want.camera, k) for k in dataclasses.asdict(got.camera)}
    assert got.scene.has_textures and got.scene.has_noise
    assert got.scene.materials.tex_id.tolist() == [0, 1, 2, 3, 4, -1]
    assert_scene_equal(got.scene, want.scene)


def test_complete_hit_uvs_match_bpt_tpu(tmp_path):
    """The hit record's interpolated UVs (both read the un-interpolated
    barycentrics) against bpt_tpu's complete_hit, at f64."""
    path = atlas(tmp_path)
    port = _uv_builder(tbuilder, ttex, path).build(device="cpu", dtype=torch.float64)
    js = _uv_builder(jbuilder, jtex, path).build(dtype=jnp.float64)
    g = np.random.default_rng(4)
    B = 3000
    o = g.uniform(-4, 4, (B, 3)) + [0, 3, 0]
    d = g.normal(size=(B, 3))
    jo, jd = jv3.from_array(jnp.asarray(o)), jv3.from_array(jnp.asarray(d))
    jh = jsoa.closest_hit(js, jo, jd, 1e-3, jnp.inf)
    want = jsoa.complete_hit(js, jo, jd, jh)
    to, td = (Vec3(*torch.from_numpy(x).unbind(1)) for x in (o, d))
    th = tsoa.closest_hit(port, to, td, 1e-3, torch.inf)
    got = tsoa.complete_hit(port, to, td, th)
    hit = np.asarray(want.hit)
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_array_equal(got.tri.numpy()[hit], np.asarray(want.tri)[hit])
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit], rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    # the interpolation moved them off the barycentrics
    assert not np.allclose(got.u.numpy()[hit], th.u.numpy()[hit])


def test_textured_pt_estimator_matches_bpt_tpu_f64(tmp_path):
    """PT on the textured cornell variant of torch_parity.textured_cornell
    (a checker wall, a noise block, an image-textured box and sphere, a
    checker light) at f64 with injected uniforms: radiance to 1e-12, every
    counter equal."""
    js, ts = textured_cornell_pair(tmp_path)
    B, depth = 128, 4
    o, d = (x.astype(np.float64) for x in rays(B, 21))
    U = np.random.default_rng(22).uniform(size=(B, depth, jpt.NU))
    rad_j, st_j = jpt.path_trace_radiance(js, jnp.asarray(o), jnp.asarray(d), depth,
                                          jpt.array_uniforms_fn(jnp.asarray(U)))
    rad_t, st_t = tpt.path_trace_radiance(ts, torch.from_numpy(o), torch.from_numpy(d), depth,
                                          tpt.array_uniforms_fn(torch.from_numpy(U)))
    assert rad_t.dtype == torch.float64
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=1e-12, atol=1e-12)
    assert float(rad_t.sum()) > 0
    for name in st_j._fields:
        assert int(getattr(st_t, name)) == int(getattr(st_j, name)), name


# -------------------------------------------------------------------- CLI


_NO_JAX = (
    "import sys\n"
    "from bpt_tpu_torch.render import main\n"
    "rc = main(sys.argv[1:])\n"
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "       or m == 'bpt_tpu' or m.startswith('bpt_tpu.')]\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n"
)


@pytest.mark.parametrize("integrator", ["pt", "bdpt"])
def test_cli_renders_earth(tmp_path, integrator):
    """scenes/earth.yaml at 4x4, 1 spp on the CPU, without JAX: the image
    equals render()'s and is not black."""
    from bpt_tpu_torch.utils.png import read_png

    args = [EARTH, "--device", "cpu", "--integrator", integrator, "--size", "4x4",
            "--spp", "1", "--max-depth", "3", "--output", "e.png", "--output-dir",
            str(tmp_path), "--no-progress"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = tloader.load_scene_from_yaml(EARTH, device="cpu", verbose=False)
    cfg = dataclasses.replace(loaded.camera, image_width=4, aspect_ratio=1.0,
                              samples_per_pixel=1, max_depth=3, integrator=integrator)
    want = render(loaded.scene, cfg, seed=0).rgb8()
    np.testing.assert_array_equal(read_png(str(tmp_path / "e.png")), want)
    assert want.any()
