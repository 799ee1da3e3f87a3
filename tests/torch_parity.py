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
