"""bpt_tpu_torch's sample-sharded render against bpt_tpu's on a CPU, in
float64 on the cornell box (8x8, 4 spp, depth 3): the port's
``render_spp_sharded`` on four CPU devices against ``bpt_tpu.parallel.
mesh.render_spp_sharded_step`` on four of the conftest's virtual devices,
strata 0-3 in one call.  Both run the jnp stratum stream and sum the four
strata, so they agree to 1e-12.  Pixel sharding:
``test_torch_distributed_parity.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models.camera import camera_constants as jcamera_constants
from bpt_tpu.parallel import mesh as jmesh
from bpt_tpu.scene import presets as jpresets
from bpt_tpu_torch.parallel import render_spp_sharded
from bpt_tpu_torch.scene import presets as tpresets

CPU = torch.device("cpu")
W, SPP, DEPTH, SEED = 8, 4, 3, 3


def _cfg(presets, integrator):
    return dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                               samples_per_pixel=SPP, max_depth=DEPTH, integrator=integrator)


@pytest.fixture(scope="module")
def scenes():
    return (jpresets.cornell_box(dtype=jnp.float64),
            tpresets.cornell_box(device="cpu", dtype=torch.float64))


@pytest.mark.parametrize("integrator", ["pt", "bdpt-mis"])
def test_spp_sharded_matches_bpt_tpu(scenes, integrator):
    jscene, tscene = scenes
    cfg = _cfg(jpresets, integrator)
    step = jmesh.render_spp_sharded_step(jmesh.make_mesh(4), integrator, DEPTH,
                                         cfg.sqrt_spp, W * W)
    want = np.asarray(step(jscene, jcamera_constants(cfg, jnp.float64),
                           jax.random.PRNGKey(SEED), jnp.int32(0)))
    got, _ = render_spp_sharded(tscene, _cfg(tpresets, integrator), mesh=[CPU] * 4,
                                seed=SEED, s0=0)
    assert float(want.mean()) > 0.05
    np.testing.assert_allclose(got.reshape(-1, 3), want, rtol=0, atol=1e-12)
