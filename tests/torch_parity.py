"""Shared helpers of the tests that hold bpt_tpu_torch against bpt_tpu:
scene carry-over from a bpt_tpu SceneArrays, scenes built the same way by
both packages' builders, and seeded ray batches."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bpt_tpu_torch.scene.types import scene_from_numpy

# One intra-op thread a process.  The suite runs under pytest-xdist, six
# workers on eight cores, and each worker imports every test module while
# it collects, so this holds in all of them.  Six processes at torch's
# default of eight threads each oversubscribe the cores: the 64x64 cornell
# goldens through the stratum loop took 505 s (pt) and 676 s (bdpt) a
# process with six running, 1.6 s and 6.3 s at one thread (0.6 s and 1.7 s
# alone at eight).
torch.set_num_threads(1)


def to_port(jscene, device="cpu", dtype=torch.float32):
    """bpt_tpu SceneArrays -> bpt_tpu_torch SceneTensors via numpy."""
    import jax  # here, so that the card-only tests need no JAX

    arrays, meta = {}, {}
    for f in dataclasses.fields(jscene):
        val = getattr(jscene, f.name)
        if dataclasses.is_dataclass(val):  # the material and texture tables
            for mf in dataclasses.fields(val):
                arrays[f"{f.name}.{mf.name}"] = np.asarray(getattr(val, mf.name))
        elif isinstance(val, jax.Array):
            arrays[f.name] = np.asarray(val)
        else:
            meta[f.name] = val
    return scene_from_numpy(arrays, meta, device=device, dtype=dtype)


def assert_scene_equal(port, jscene):
    """Every array and meta field the port carries equals bpt_tpu's, the
    texture table's included."""
    from bpt_tpu_torch.scene.types import scene_to_numpy

    ref = to_port(jscene, dtype=port.dtype)
    arrays, meta = scene_to_numpy(port)
    ref_arrays, ref_meta = scene_to_numpy(ref)
    assert meta == ref_meta
    assert set(arrays) == set(ref_arrays)
    for name, a in arrays.items():
        assert a.dtype == ref_arrays[name].dtype, name
        np.testing.assert_array_equal(a, ref_arrays[name], err_msg=name)


def mixed_scene(builder_mod, presets_mod, **build_kw):
    """The cornell box plus a fuzzy metal quad, a dielectric box and an
    isotropic quad, built by either package's builder."""
    MS = builder_mod.MaterialSpec
    b = presets_mod.cornell_box_builder()
    b.add_quad((60, 20, 60), (150, 0, 0), (0, 150, 40), MS.metal((0.8, 0.85, 0.9), 0.3))
    b.add_box((340, 0, 80), (460, 120, 200), MS.dielectric(1.5))
    b.add_quad((100, 400, 400), (120, 0, 0), (0, 0, 100), MS.isotropic((0.6, 0.7, 0.5)))
    return b.build(**build_kw)


def rays(B, seed):
    """Random rays inside the cornell box (numpy-seeded, f32)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(50, 500, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    return o, d


def big_scene(builder_mod, **build_kw):
    """A metal UV sphere on a floor under a quad light: 964 triangles, over
    the fused kernels' 512 (tests/test_pallas_kernels.py::_big_scene)."""
    MS = builder_mod.MaterialSpec
    b = builder_mod.SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, MS.metal((0.8, 0.8, 0.8), 0.05))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), MS.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4), MS.diffuse_light((10, 10, 10)))
    return b.build(**build_kw)


def big_rays(B, seed):
    """Random rays around the big scene's sphere (numpy-seeded, f32), a
    few with zero direction components (the slab test's NaN terms)."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-3, 3, (B, 3)) * [1, 0.5, 1] + [0, 2.5, 0]).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[:8, 0] = 0.0
    o[:4, 0] = 0.0
    return o, d


def shadow_wave(S, B, seed, dtype=np.float32):
    """The lanes of a BDPT shadow wave in the cornell box, [S, B] flattened
    row by row as ``models/bdpt.py`` lays out its connections (row n: light
    vertex n of every camera lane), numpy-seeded: each camera lane's origin
    repeated over the rows, directions to random points of the box, tmax
    just short of them.  Row n is live with a probability falling from 0.9
    to 0.1, four runs of 128 lanes (four warps) are dead, a dead lane is masked as
    ``ops/soa.py`` masks it (tmax 0 < tmin = 1e-3), and one lane in 50 has
    a NaN tmax.  Returns (o [S*B, 3], d [S*B, 3], tmin, tmax, live [S*B])."""
    g = np.random.default_rng(seed)
    o = np.repeat(g.uniform(50, 500, (1, B, 3)), S, axis=0).reshape(-1, 3)
    d = g.uniform(0, 555, (S * B, 3)) - o
    dist = np.linalg.norm(d, axis=1)
    d = d / dist[:, None]
    live = g.uniform(size=S * B) < np.linspace(0.9, 0.1, S).repeat(B)
    for s in g.integers(0, S * B - 128, 4):
        live[s:s + 128] = False
    tmin = np.full(S * B, 1e-3)
    tmax = np.where(live, dist * 0.999, 0.0)
    tmax[g.uniform(size=S * B) < 0.02] = np.nan
    return (o.astype(dtype), d.astype(dtype), tmin.astype(dtype), tmax.astype(dtype),
            live & ~np.isnan(tmax))


def endpoint_ties(tmax, live, t_a, t_b):
    """tmax with every third live lane whose hit both sides put at the same
    t ending exactly there (a ref_vis connection's endpoint: t == tmax,
    inclusive); returns (tmax, the tie lanes)."""
    ties = live & np.isfinite(t_a) & (t_a == t_b) & (np.arange(tmax.shape[0]) % 3 == 0)
    return np.where(ties, t_a, tmax).astype(tmax.dtype), ties


def atlas(tmp_path, h=6, w=8, seed=3):
    """A seeded RGB image written with Pillow; returns its path."""
    from PIL import Image

    px = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = tmp_path / "atlas.png"
    Image.fromarray(px).save(path)
    return str(path)


def textured_cornell(builder_mod, tex_mod, image_path, **build_kw):
    """The cornell box with a checker back wall (z = 555 off the scale-60
    cells' boundaries), a noise block, an image-textured box, a small
    image-textured sphere, and a checker light (y = 554, scale 37)."""
    MS, TS = builder_mod.MaterialSpec, tex_mod.TextureSpec
    b = builder_mod.SceneBuilder()
    red = MS.lambertian((0.65, 0.05, 0.05))
    white = MS.lambertian((0.73, 0.73, 0.73))
    green = MS.lambertian((0.12, 0.45, 0.15))
    wall = MS.lambertian(texture=TS.checker(60.0, (0.8, 0.7, 0.2), (0.2, 0.3, 0.8)))
    light = MS.diffuse_light((15.0, 15.0, 15.0),
                             texture=TS.checker(37.0, (15.0, 14.0, 11.0), (5.0, 7.0, 16.0)))
    img = MS.lambertian(texture=TS.image(image_path))
    b.add_quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green)
    b.add_quad((0, 0, 555), (0, 0, -555), (0, 555, 0), red)
    b.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white)
    b.add_quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), wall)
    b.add_quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    b.add_box((0, 0, 0), (165, 330, 165), img, rotate_y_degrees=15.0, translate=(265, 0, 295))
    b.add_box((60, 0, 60), (200, 140, 200), MS.lambertian(texture=TS.noise(0.04)))
    b.add_uv_sphere((420, 100, 150), 70.0, img, lat_steps=4, lon_steps=6)
    return b.build(**build_kw)


def textured_cornell_pair(tmp_path):
    """(bpt_tpu's, the port's) ``textured_cornell`` at f64 on the CPU, with
    one seeded atlas written to ``tmp_path``."""
    import jax.numpy as jnp  # here, so that the card-only tests need no JAX

    from bpt_tpu.scene import builder as jbuilder
    from bpt_tpu.scene import textures as jtex
    from bpt_tpu_torch.scene import builder as tbuilder
    from bpt_tpu_torch.scene import textures as ttex

    path = atlas(tmp_path)
    js = textured_cornell(jbuilder, jtex, path, dtype=jnp.float64)
    ts = textured_cornell(tbuilder, ttex, path, device="cpu", dtype=torch.float64)
    assert not ts.use_bvh and ts.has_textures and ts.has_noise
    return js, ts


def textured_wave_scene(mod, tex_mod, big: bool, light: bool, **build_kw):
    """tests/test_pallas_kernels.py::_textured_scene (light=False) and the
    scene of its textured-light test (light=True, the light at y = 6.03,
    off its checker's cell boundaries)."""
    MS, TS = mod.MaterialSpec, tex_mod.TextureSpec
    b = mod.SceneBuilder()
    tex = TS.checker(0.35, (0.9, 0.3, 0.2), (0.1, 0.8, 0.3))
    kw = dict(lat_steps=16, lon_steps=32) if big else dict(lat_steps=4, lon_steps=6)
    b.add_uv_sphere((0, 1, 0), 1.0, MS.lambertian((1, 1, 1), texture=tex), **kw)
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), MS.lambertian((0.6, 0.6, 0.6)))
    if light:
        ltex = TS.checker(0.5, (12.0, 10.0, 4.0), (2.0, 2.0, 10.0))
        b.add_quad((-2, 6.03, -2), (4, 0, 0), (0, 0, 4),
                   MS.diffuse_light((1, 1, 1), texture=ltex))
    else:
        b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4), MS.diffuse_light((10, 10, 10)))
    return b.build(**build_kw)


def smoke_scene(builder_mod, **build_kw):
    """The cornell box of scenes/cornell_smoke.yaml with its dark smoke box
    and light fog box (tests/test_pallas_kernels.py::_smoke_scene_f32),
    built by either package's builder: 12 triangles, 2 volumes over 24
    boundary triangles."""
    MS = builder_mod.MaterialSpec
    b = builder_mod.SceneBuilder()
    b.add_quad((555, 0, 0), (0, 0, 555), (0, 555, 0), MS.lambertian((0.12, 0.45, 0.15)))
    b.add_quad((0, 0, 555), (0, 0, -555), (0, 555, 0), MS.lambertian((0.65, 0.05, 0.05)))
    b.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555), MS.lambertian((0.73, 0.73, 0.73)))
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 0, -555), MS.lambertian((0.73, 0.73, 0.73)))
    b.add_quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), MS.lambertian((0.73, 0.73, 0.73)))
    b.add_quad((113, 554, 127), (330, 0, 0), (0, 0, 305), MS.diffuse_light((7.0, 7.0, 7.0)))
    b.add_volume_box((120, 0.01, 65), (285, 165, 230), density=0.01, albedo=(0.0, 0.0, 0.0),
                     rotate_y_degrees=-18.0)
    b.add_volume_box((265, 0.01, 295), (430, 330, 460), density=0.005,
                     albedo=(1.0, 1.0, 1.0), rotate_y_degrees=15.0)
    return b.build(**build_kw)


def volume_big_scene(builder_mod, texture=None, **build_kw):
    """big_scene with a constant-density box around the sphere
    (tests/test_pallas_kernels.py:1189-1231): 964 triangles, one volume;
    ``texture``: its phase function's texture."""
    MS = builder_mod.MaterialSpec
    b = builder_mod.SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, MS.metal((0.8, 0.8, 0.8), 0.05))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), MS.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4), MS.diffuse_light((10, 10, 10)))
    b.add_volume_box((-1.5, 0.01, -1.5), (1.5, 2.5, 1.5), density=0.2,
                     albedo=(0.9, 0.9, 0.9), texture=texture)
    return b.build(**build_kw)


def recorded_any_hits(monkeypatch):
    """Records every shadow wave of both packages' BDPT: (directions [N,
    3], mask, answers)."""
    from bpt_tpu.core import vec3 as jv3
    from bpt_tpu.ops import soa as jsoa
    from bpt_tpu_torch.ops import soa as tsoa

    waves = {"j": [], "t": []}
    j_any, t_any = jsoa.any_hit, tsoa.any_hit

    def j_rec(scene, o_, d_, tmin, tmax, mask=None):
        r = j_any(scene, o_, d_, tmin, tmax, mask)
        waves["j"].append((np.asarray(jv3.to_array(d_)).reshape(-1, 3),
                           np.asarray(mask).reshape(-1), np.asarray(r).reshape(-1)))
        return r

    def t_rec(scene, o_, d_, tmin, tmax, mask=None, plain=False):
        r = t_any(scene, o_, d_, tmin, tmax, mask, plain)
        waves["t"].append((torch.stack(list(d_), -1).numpy().reshape(-1, 3),
                           mask.numpy().reshape(-1), r.numpy().reshape(-1)))
        return r

    monkeypatch.setattr(jsoa, "any_hit", j_rec)
    monkeypatch.setattr(tsoa, "any_hit", t_rec)
    return waves


def coplanar_shadow_gap(waves) -> int:
    """The shadow pairs that one side tests and the other does not, each a
    connection that runs within 1e-12 of an axis-aligned plane on both
    sides (ROADMAP §3: XLA's contracted hit point puts a floor vertex at
    y = 0 or ~1e-19, and the pair passes the cosine test on one side only);
    every pair both sides test gets the same answer."""
    assert len(waves["j"]) == len(waves["t"]) > 0
    n_diff = 0
    for (jd, jm, jr), (td, tm, tr) in zip(waves["j"], waves["t"]):
        differ = jm != tm
        n_diff += int(differ.sum())
        for dirs in (jd[differ], td[differ]):
            flat = np.abs(dirs).min(axis=1) <= 1e-12 * np.linalg.norm(dirs, axis=1)
            assert flat.all(), dirs[~flat]
        both = jm & tm
        np.testing.assert_array_equal(jr[both], tr[both])
    return n_diff


def box_rays(B, seed, dtype=np.float64):
    """Rays from the cornell camera's position to random points of the box
    (bpt_tpu's tests/test_pallas_kernels.py::_box_rays)."""
    g = np.random.default_rng(seed)
    o = np.tile([[278.0, 278.0, -800.0]], (B, 1))
    d = g.uniform(50, 500, (B, 3)) - o
    return o.astype(dtype), d.astype(dtype)
