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
        if f.name == "materials":
            for mf in dataclasses.fields(val):
                arrays["materials." + mf.name] = np.asarray(getattr(val, mf.name))
        elif isinstance(val, jax.Array):
            arrays[f.name] = np.asarray(val)
        elif not dataclasses.is_dataclass(val):
            meta[f.name] = val
    return scene_from_numpy(arrays, meta, device=device, dtype=dtype)


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
