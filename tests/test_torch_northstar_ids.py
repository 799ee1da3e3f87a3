"""The north-star's samples through the port's plain pixels-mode kernels
against ``bpt_tpu``'s Pallas kernels in interpret mode, on a CPU: the
glass stand-in at 1920x1080, 1024 spp (sample ids pix * 1024 + s).

- The largest sample ids it draws: the last 8 pixels at strata [1020,
  1024) (ids up to 2,123,366,399), depth 2 (~10 s a kernel).
- Its full depth, 80, on 64 seeded samples of the image's lower half (rows
  528:1080, the lit floor and the glass's base, where bdpt-mis departs
  from PT: ROADMAP §3), each at a seeded stratum of 1024 (~15 s a kernel).
  On 256 samples drawn the same way, the BDPT radiance of one sample
  (row 702, column 1323, stratum 985) differs by 1.2e-4 relative, over
  rtol, with its own rays and shadow rays equal, and the rays of the 256
  differ by 11 of 1,323: float32 rounding gaps between the two CPU
  implementations, of the kind test_torch_bdpt.py describes, not traced
  further.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import camera as jcam
from bpt_tpu.ops.pallas import bdpt_kernel as jbk
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu.scene.loader import load_scene_from_yaml as jload
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.models import camera as tcam
from bpt_tpu_torch.ops.kernels import bdpt_kernel as tbk
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene.loader import load_scene_from_yaml as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLASS = os.path.join(ROOT, "scenes", "glass", "glass_standin.yaml")
W, H, SQRT = 1920, 1080, 32
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def glass():
    """(bpt_tpu's scene and 1080p camera table, the port's: the same scene
    without its BVH, whose plain versions then sweep the 510 triangles and
    count as the brute-force kernels do, and its camera table)."""
    kw = dict(image_width=W, aspect_ratio=16 / 9, samples_per_pixel=SQRT * SQRT)
    jl = jload(GLASS, dtype=jnp.float32, verbose=False)
    tl = tload(GLASS, dtype=torch.float32, device="cpu", verbose=False)
    ccj = jcam.camera_constants(dataclasses.replace(jl.camera, **kw), jnp.float32)
    cct = tcam.camera_constants(dataclasses.replace(tl.camera, **kw), torch.float32)
    assert (cct.width, cct.height, cct.sqrt_spp) == (W, H, SQRT)
    return (jl.scene, jk.camera_table(ccj), dataclasses.replace(tl.scene, use_bvh=False),
            tk.camera_table(cct))


def _lanes(which):
    """Pixel coordinates, strata and sample ids of a lane set: "last", the
    last 8 pixels x strata [1020, 1024); "lower", 64 seeded pixels of rows
    528:1080, each at a seeded stratum."""
    if which == "last":
        pix = np.repeat(np.arange(W * H - 8, W * H), 4)
        s = np.tile(np.arange(1020, 1024), 8)
    else:
        g = np.random.default_rng(0)
        pix = g.integers(528 * W, H * W, size=64)
        s = g.integers(0, SQRT * SQRT, size=64)
    ids = (pix * SQRT * SQRT + s).astype(np.int32)
    if which == "last":
        assert int(ids.max()) == 2_123_366_399 < 2**31
    return ((pix % W).astype(np.float32), (pix // W).astype(np.float32),
            (s % SQRT).astype(np.float32), (s // SQRT).astype(np.float32), ids)


LANES = [("last", 2), ("lower", 80)]


@pytest.mark.parametrize("which, depth", LANES)
def test_north_star_samples_pt_match_pallas(glass, which, depth):
    """PT pixels mode with one sample a lane (spp_loop 1: the lane's id is
    the sample id, its stratum sx, sy): radiance within rtol 1e-4 / atol
    1e-6, rays and every counter exact."""
    js, jcam13, ts, tcam13 = glass
    i, j, sx, sy, ids = _lanes(which)
    want = jk.pt_megakernel_pixels(js, *map(jnp.asarray, (i, j, sx, sy, ids)), jcam13,
                                   jax.random.PRNGKey(0), depth, interpret=True)
    got = tk.pt_megakernel_pixels(ts, *map(torch.from_numpy, (i, j, sx, sy, ids)), tcam13,
                                  rng.prng_key(0), depth)
    g = np.stack([t.numpy() for t in got[:3]], -1)
    w = np.stack([np.asarray(x) for x in want[:3]], -1)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert g.any() and int(got[3]) == int(want[3]) > 0
    assert [int(x) for x in got[4]] == [int(x) for x in np.asarray(want[4])]


@pytest.mark.parametrize("which, depth", LANES)
def test_north_star_samples_bdpt_mis_match_pallas(glass, which, depth):
    """BDPT-MIS pixels mode at sqrt_spp 1, whose one stratum's id is the
    lane's id: the lanes carry the north-star's sample ids and its stratum
    in the pixel coordinate (i + sx / 32, j + sy / 32, against the 1024-spp
    camera table).  Radiance within rtol 1e-4 / atol 1e-6, every counter
    exact.  (bdpt without MIS compiles a kernel of its own, another ~10 s
    here; its shadow rays differ from the Pallas kernel's on connections
    between two floor vertices, which pass the cosine test on one side only:
    ROADMAP §3.)"""
    js, jcam13, ts, tcam13 = glass
    i, j, sx, sy, ids = _lanes(which)
    ib, jb = i + sx / SQRT, j + sy / SQRT
    want = jbk.bdpt_megakernel_pixels(js, jnp.asarray(ib), jnp.asarray(jb), jnp.asarray(ids),
                                      jcam13, jax.random.PRNGKey(0), depth, 1, interpret=True,
                                      mis=True)
    got = tbk.bdpt_megakernel_pixels(ts, torch.from_numpy(ib), torch.from_numpy(jb),
                                     torch.from_numpy(ids), tcam13, rng.prng_key(0), depth, 1,
                                     mis=True)
    g = np.stack([t.numpy() for t in got[:3]], -1)
    w = np.stack([np.asarray(x) for x in want[:3]], -1)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert g.any() and int(got[3]) == int(want[3]) > 0 and int(got[4]) > 0
    assert [int(got[4]), *(int(x) for x in got[5])] == [
        int(want[4]), *(int(x) for x in np.asarray(want[5]))]
