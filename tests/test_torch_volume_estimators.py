"""bpt_tpu_torch's jnp estimators on a volume scene against bpt_tpu's:
``path_trace_radiance`` at depths 2 and 5 and ``bdpt_radiance`` (bdpt and
bdpt-mis) at depth 4 on the smoke cornell box (two constant-density
boxes), f64, injected draws (NU + V slots a PT bounce, NT + V a BDPT trace
bounce, the free-flight draws last).

Tolerances: radiance within 1e-12 (ROADMAP "Numerics") and every counter
equal, but bdpt's shadow rays, which may differ by the coplanar pairs of
ROADMAP §3: XLA's CPU backend contracts the hit point o + t*d, so a floor
vertex lands at y = 0 on one side and ~1e-19 on the other, and a
connection along the floor passes the cosine test on one side only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import bdpt as jbdpt
from bpt_tpu.models import pt as jpt
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.scene import builder as tbuilder
from torch_parity import box_rays, coplanar_shadow_gap, recorded_any_hits, smoke_scene


@pytest.fixture(scope="module")
def smoke64():
    return (smoke_scene(jbuilder, dtype=jnp.float64),
            smoke_scene(tbuilder, device="cpu", dtype=torch.float64))


@pytest.mark.parametrize("depth", [2, 5])
def test_path_trace_radiance_volumes_f64(smoke64, depth):
    js, ts = smoke64
    B = 256
    o, d = box_rays(B, 40 + depth)
    U = np.random.default_rng(depth).uniform(size=(B, depth, tpt.NU + 2))
    want, st_j = jpt.path_trace_radiance(js, jnp.asarray(o), jnp.asarray(d), depth,
                                         jpt.array_uniforms_fn(jnp.asarray(U)))
    got, st_t = tpt.path_trace_radiance(ts, torch.from_numpy(o), torch.from_numpy(d), depth,
                                        tpt.array_uniforms_fn(torch.from_numpy(U)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert float(got.sum()) > 0
    for name in st_j._fields:
        assert int(getattr(st_t, name)) == int(getattr(st_j, name)), name


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
def test_bdpt_radiance_volumes_f64(smoke64, mis, monkeypatch):
    """Radiance within 1e-12 and every counter equal, but bdpt's shadow
    rays, which may differ by the coplanar pairs of ROADMAP §3 (a pair
    tested on one side only runs within 1e-12 of an axis-aligned plane)."""
    js, ts = smoke64
    waves = recorded_any_hits(monkeypatch)
    B, depth, ntv = 96, 4, tbdpt.NT + 2
    o, d = box_rays(B, 23 + int(mis))
    g = np.random.default_rng(29 + int(mis))
    cam_u = g.uniform(size=(B, depth, ntv))
    ls_u = g.uniform(size=(B, tbdpt.NLS))
    light_u = g.uniform(size=(B, depth - 1, ntv))
    want, st_j = jbdpt.bdpt_radiance(
        js, jnp.asarray(o), jnp.asarray(d), depth, jpt.array_uniforms_fn(jnp.asarray(cam_u)),
        jnp.asarray(ls_u), jpt.array_uniforms_fn(jnp.asarray(light_u)), mis=mis)
    got, st_t = tbdpt.bdpt_radiance(
        ts, torch.from_numpy(o), torch.from_numpy(d), depth,
        tpt.array_uniforms_fn(torch.from_numpy(cam_u)), torch.from_numpy(ls_u),
        tpt.array_uniforms_fn(torch.from_numpy(light_u)), mis=mis)
    gap = coplanar_shadow_gap(waves)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert float(got.sum()) > 0 and int(st_t.shadow_rays) > 0
    for name in st_j._fields:
        diff = abs(int(getattr(st_t, name)) - int(getattr(st_j, name)))
        assert diff <= (gap if name == "shadow_rays" else 0), name
