"""bpt_tpu_torch's BDPT and BDPT-MIS jnp estimators on a textured scene
against bpt_tpu's, at f64 with injected uniforms on a cornell variant with
a checker wall, a noise block, an image-textured box and sphere and a
checker-textured light (``torch_parity.textured_cornell``); PT's is in
``test_torch_textures.py`` (each file stays under a minute on a loaded
test host: JAX's op-by-op compiles of bpt_tpu's estimators are most of
it).

Tolerances: radiance to 1e-12 (ROADMAP "Numerics") and every counter
equal, but bdpt's shadow rays, which may differ by the coplanar pairs of
ROADMAP §3: XLA's CPU backend contracts the hit point o + t*d, so a floor
vertex lands at y = 0 on one side and ~1e-19 on the other, and a
connection along the floor passes the cosine test on one side only.  Such
pairs carry no radiance; every pair both sides test gets the same
answer."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import bdpt as jbdpt
from bpt_tpu.models import pt as jpt
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import pt as tpt
from torch_parity import coplanar_shadow_gap, rays, recorded_any_hits, textured_cornell_pair

B_EST, DEPTH_EST = 128, 4


@pytest.fixture(scope="module")
def cornell_pair(tmp_path_factory):
    return textured_cornell_pair(tmp_path_factory.mktemp("atlas"))


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_textured_estimators_match_bpt_tpu_f64(cornell_pair, integrator, monkeypatch):
    """BDPT and BDPT-MIS on the textured cornell variant at f64 with
    injected uniforms: radiance to 1e-12 and every counter equal but
    bdpt's shadow rays, which may differ by the coplanar pairs of ROADMAP
    §3 (radiance-free connections along a wall)."""
    js, ts = cornell_pair
    o, d = (x.astype(np.float64) for x in rays(B_EST, 21))
    g = np.random.default_rng(22)
    mis = integrator == "bdpt-mis"
    waves = recorded_any_hits(monkeypatch)
    cam_u = g.uniform(size=(B_EST, DEPTH_EST, jbdpt.NT))
    ls_u = g.uniform(size=(B_EST, jbdpt.NLS))
    light_u = g.uniform(size=(B_EST, DEPTH_EST - 1, jbdpt.NT))
    rad_j, st_j = jbdpt.bdpt_radiance(
        js, jnp.asarray(o), jnp.asarray(d), DEPTH_EST,
        jpt.array_uniforms_fn(jnp.asarray(cam_u)), jnp.asarray(ls_u),
        jpt.array_uniforms_fn(jnp.asarray(light_u)), mis=mis)
    rad_t, st_t = tbdpt.bdpt_radiance(
        ts, torch.from_numpy(o), torch.from_numpy(d), DEPTH_EST,
        tpt.array_uniforms_fn(torch.from_numpy(cam_u)), torch.from_numpy(ls_u),
        tpt.array_uniforms_fn(torch.from_numpy(light_u)), mis=mis)
    assert int(st_t.shadow_rays) > 0
    gap = coplanar_shadow_gap(waves)
    assert rad_t.dtype == torch.float64
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=1e-12, atol=1e-12)
    assert float(rad_t.sum()) > 0
    for name in st_j._fields:
        diff = abs(int(getattr(st_t, name)) - int(getattr(st_j, name)))
        assert diff <= (gap if name == "shadow_rays" else 0), name


def test_textures_change_the_estimate(cornell_pair):
    """The same paths on the scene with every texture dropped give another
    image: the texels are read."""
    _, ts = cornell_pair
    flat = dataclasses.replace(ts, has_textures=False, has_noise=False)
    o, d = (torch.from_numpy(x.astype(np.float64)) for x in rays(64, 23))
    U = torch.from_numpy(np.random.default_rng(24).uniform(size=(64, 3, tpt.NU)))
    a, sa = tpt.path_trace_radiance(ts, o, d, 3, tpt.array_uniforms_fn(U))
    b, sb = tpt.path_trace_radiance(flat, o, d, 3, tpt.array_uniforms_fn(U))
    assert not torch.allclose(a, b) and int(sa.rays_traced) == int(sb.rays_traced)
