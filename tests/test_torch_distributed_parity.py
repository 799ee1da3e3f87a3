"""bpt_tpu_torch's pixel-sharded render against bpt_tpu's on a CPU, in
float64 on the cornell box (8x8, 4 spp, depth 3): the port's
``render_distributed(fast="never")`` on three CPU devices against
``bpt_tpu.parallel.mesh.render_distributed(fast="never")`` on the
conftest's eight virtual devices.  Both run the jnp stratum stream, so
they agree to 1e-12 (as the stratum loop does, ``test_torch_jnp_loop.py``);
the mesh sizes differ on purpose, since neither image depends on them.
Sample sharding: ``test_torch_spp_parity.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.parallel import mesh as jmesh
from bpt_tpu.scene import presets as jpresets
from bpt_tpu_torch.parallel import render_distributed
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
def test_pixel_sharded_matches_bpt_tpu(scenes, integrator):
    jscene, tscene = scenes
    assert len(jax.devices()) == 8
    want, spp = jmesh.render_distributed(jscene, _cfg(jpresets, integrator),
                                         mesh=jmesh.make_mesh(8), seed=SEED, fast="never")
    got, got_spp, stats = render_distributed(tscene, _cfg(tpresets, integrator),
                                             mesh=[CPU] * 3, seed=SEED, fast="never")
    assert got_spp == spp == SPP and stats.rays_traced > 0
    assert float(want.mean()) > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
