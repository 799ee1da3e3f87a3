"""The slice as a whole: ``scenes/cornell_smoke.yaml`` (two constant-
density boxes) at 16x16, 4 spp, depth 4 in float64 through bpt_tpu_torch's
render(), which takes its stratum loop (``models/render.py::
_render_strata``), against bpt_tpu's render() on a CPU, its stratum loop.

Tolerances: the framebuffer within 1e-12 (ROADMAP "Numerics"), rays and
the hit counters equal.  Shadow rays: equal under pt (none) and within 3%
under bdpt, whose unweighted connections along the floor pass the cosine
test on one side only (XLA's CPU backend contracts the hit point o + t*d:
a floor vertex at y = 0 on one side, ~1e-19 on the other; ROADMAP §3,
where bpt_tpu's count runs 2.9% above the port's on the coffee subset).
Such pairs carry no radiance: the images agree to 1e-12."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models.render import render as jrender
from bpt_tpu.scene import loader as jloader
from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.scene import loader as tloader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("rays_traced", "shadow_rays", "bvh_node_visits", "aabb_hits", "triangle_tests",
         "triangle_hits")


@pytest.mark.parametrize("integrator", ["pt", "bdpt"])
def test_cornell_smoke_strata_matches_bpt_tpu_render(integrator):
    """The slice as a whole: scenes/cornell_smoke.yaml at 16x16, 4 spp,
    depth 4 in float64 through the port's render(), which takes the
    stratum loop (_render_strata), against bpt_tpu's render() on a CPU, its
    stratum loop: the framebuffer within 1e-12, rays equal."""
    path = os.path.join(ROOT, "scenes", "cornell_smoke.yaml")
    over = dict(image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
                integrator=integrator)
    tl = tloader.load_scene_from_yaml(path, dtype=torch.float64, device="cpu",
                                      camera_overrides=over, verbose=False)
    jl = jloader.load_scene_from_yaml(path, dtype=jnp.float64, camera_overrides=over,
                                      verbose=False)
    assert tl.scene.num_volumes == 2
    assert trender._route(tl.scene, tl.camera, integrator, None) == "strata"
    got = trender.render(tl.scene, tl.camera, seed=5)
    want = jrender(jl.scene, jl.camera, seed=5)
    assert float(want.framebuffer_sum.mean()) > 0.01
    np.testing.assert_allclose(got.framebuffer_sum, want.framebuffer_sum, rtol=0, atol=1e-12)
    for k in STATS:
        g_, w_ = getattr(got.stats, k), getattr(want.stats, k)
        assert abs(g_ - w_) <= (3 * w_ // 100 if k == "shadow_rays" else 0), k
