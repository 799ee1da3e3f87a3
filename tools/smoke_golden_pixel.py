"""The one pixel where the port's stratum loop departs from
tests/golden/smoke_pt.png (tools/gen_goldens.py's smoke_pt: 48x48, 9 spp,
depth 5, seed 1234, float32), on a CPU.

    python tools/smoke_golden_pixel.py   # ~1 min

Renders the golden's configuration through the port's ``_render_strata``
and prints the pixels that differ from the golden and the RMSE.  For each
differing pixel it prints the radiance of its nine samples from the port's
``path_trace_pixels_fast`` and from ``bpt_tpu``'s, once jitted (as
gen_goldens.py's render runs it: XLA fuses the estimator and contracts
a*b+c) and once op by op under ``jax.disable_jit`` (no fusion).  The port's
samples equal the op-by-op ones; a sample that differs from the jitted one
is XLA's contraction.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

W, SPP, SQRT, DEPTH, SEED = 48, 9, 3, 5, 1234


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from bpt_tpu.models import pt as jpt
    from bpt_tpu.models.camera import camera_constants as jcc
    from bpt_tpu.scene import builder as jbuilder
    from bpt_tpu.scene.presets import cornell_box_camera as jcamera
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models import pt as tpt
    from bpt_tpu_torch.models import render as trender
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.scene import builder as tbuilder
    from bpt_tpu_torch.scene.presets import cornell_box_camera
    from bpt_tpu_torch.utils.png import read_png
    from torch_parity import smoke_scene

    kw = dict(image_width=W, aspect_ratio=1.0, samples_per_pixel=SPP, max_depth=DEPTH,
              integrator="pt")
    scene = smoke_scene(tbuilder, device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(cornell_box_camera(), **kw)
    cc = camera_constants(cfg, torch.float32)
    fb = torch.zeros((W * W, 3))
    trender._render_strata(scene, cfg, cc, "pt", SEED, fb, None, None, None)
    img = trender.RenderResult(fb.numpy().reshape(W, W, 3), SPP, None, W, W).rgb8()
    golden = read_png(os.path.join(ROOT, "tests", "golden", "smoke_pt.png"))
    rmse = float(np.sqrt(np.mean((img / 255.0 - golden / 255.0) ** 2)))
    differ = np.argwhere((img != golden).any(-1))
    print(f"smoke_pt through the port's stratum loop: RMSE {rmse:.6f} against the golden, "
          f"{len(differ)} pixel(s) differ: {[tuple(int(x) for x in p) for p in differ]}")

    js = smoke_scene(jbuilder, dtype=jnp.float32)
    jcc_ = jcc(dataclasses.replace(jcamera(), **kw), jnp.float32)
    s = np.arange(SPP)
    for row, col in differ:
        pix = int(row) * W + int(col)
        lanes = [np.full(SPP, pix % W, np.float32), np.full(SPP, pix // W, np.float32),
                 (s % SQRT).astype(np.float32), (s // SQRT).astype(np.float32),
                 (pix * SPP + s).astype(np.int32)]
        port, _ = tpt.path_trace_pixels_fast(
            scene, *(torch.from_numpy(x) for x in lanes[:4]), torch.from_numpy(lanes[4]).long(),
            cc, rng.prng_key(SEED), DEPTH)

        def jpath(*a):
            return jpt.path_trace_pixels_fast(js, *a, jcc_, jax.random.PRNGKey(SEED), DEPTH)[0]

        jitted = np.asarray(jax.jit(jpath)(*map(jnp.asarray, lanes)))
        with jax.disable_jit():
            eager = np.asarray(jpath(*map(jnp.asarray, lanes)))
        print(f"pixel ({row}, {col}): img {img[row, col].tolist()}, golden "
              f"{golden[row, col].tolist()}")
        for k in range(SPP):
            print(f"  sample {k}: port {port[k].tolist()}, bpt_tpu jitted {jitted[k].tolist()}, "
                  f"op by op {eager[k].tolist()}")
        print(f"  port equals op by op: {bool(np.allclose(port.numpy(), eager, rtol=1e-5))}; "
              f"samples differing from jitted: "
              f"{np.flatnonzero(~np.isclose(port.numpy(), jitted, rtol=1e-5).all(-1)).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
