"""rays_traced, shadow_rays and mean radiance of the reference binary's own
BDPT configuration on a pixel subset, on a CPU, two ways: bpt_tpu's route
for it there (the jnp stratum loop: ``models.bdpt.bdpt_fast`` with
``ref_vis=True`` over the brute-force hits of ``ops.soa``, after the jnp
raygen; jitted, as its render step runs it) and the port's plain version of
its route (``models.render.jnp_raygen`` and ``models.bdpt.bdpt_fast``).

The configuration is tests/test_ref_rmse.py's: the cornell box at
256x256, 64 spp, depth 10, seed 0, float32, ref_vis; every ``--stride``-th
pixel with all its strata (at 257: 256 pixels, 16,384 samples).
chip_smoke.py holds the card's counts on that subset against these.  The
rays are tie-free and agree to the sample; a shadow ray that ends at its
connection's endpoint is decided by the last ulp of t, and XLA's CPU
backend, which contracts a*b+c, decides differently from PyTorch's strict
arithmetic (ROADMAP §3).  Takes about 30 s on a few cores, most of it XLA
compiling the depth-10 estimator.

    python tools/cornell_reference_rays_refvis.py [--stride 257]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stride", type=int, default=257)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from bpt_tpu.core import rng as jrng
    from bpt_tpu.models import bdpt as jbdpt
    from bpt_tpu.models.camera import camera_constants, generate_rays
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models import bdpt as tbdpt
    from bpt_tpu_torch.models import camera as tcamera
    from bpt_tpu_torch.models.render import jnp_raygen
    from bpt_tpu_torch.scene import presets as tpresets

    W, S, depth = 256, 8, 10
    cfg = dataclasses.replace(cornell_box_camera(), image_width=W, samples_per_pixel=S * S,
                              max_depth=depth, integrator="bdpt", ref_vis=True)
    cc = camera_constants(cfg, jnp.float32)
    pix = np.arange(0, W * W, args.stride, dtype=np.int32)
    pixb = np.tile(pix, S * S)
    s = np.repeat(np.arange(S * S, dtype=np.int32), pix.size)
    ids = pixb * S * S + s
    key = jax.random.PRNGKey(0)
    u_gen = jrng.wave_uniforms(jax.random.fold_in(key, 0), jnp.asarray(ids), 0, 4)
    o3, d3 = generate_rays(cc, *(jnp.asarray(x.astype(np.float32))
                                 for x in (pixb % W, pixb // W, s % S, s // S)), u_gen)
    print(f"{ids.size} samples ({pix.size} pixels x {S * S} strata), depth {depth}",
          flush=True)

    t0 = time.monotonic()
    scene = cornell_box(dtype=jnp.float32)
    fn = jax.jit(lambda o, d, i: jbdpt.bdpt_fast(scene, o, d, i, key, depth, ref_vis=True))
    jr, jst = fn(o3, d3, jnp.asarray(ids))
    jr = np.asarray(jr)
    t1 = time.monotonic()
    tcfg = dataclasses.replace(tpresets.cornell_box_camera(), image_width=W,
                               samples_per_pixel=S * S, max_depth=depth, integrator="bdpt",
                               ref_vis=True)
    po, pd, pids = jnp_raygen(tcamera.camera_constants(tcfg, torch.float32),
                              torch.from_numpy(pixb.astype(np.int64)),
                              torch.from_numpy(s.astype(np.int64)), rng.prng_key(0),
                              torch.float32)
    tr, tst = tbdpt.bdpt_fast(tpresets.cornell_box(device="cpu"), po, pd, pids,
                              rng.prng_key(0), depth, ref_vis=True)
    tr = tr.numpy()
    t2 = time.monotonic()
    jc = (int(jst.rays_traced), int(jst.shadow_rays), float(jr.mean()))
    tc = (int(tst.rays_traced), int(tst.shadow_rays), float(tr.mean()))
    print(f"raygen: port - bpt_tpu max |o| {np.abs(po.numpy() - np.asarray(o3)).max():.3e}, "
          f"max |d| {np.abs(pd.numpy() - np.asarray(d3)).max():.3e}")
    print(f"bpt_tpu CPU route (jnp stratum loop, brute force, ref_vis): rays {jc[0]}, shadow "
          f"rays {jc[1]}, mean radiance {jc[2]:.6f} ({t1 - t0:.1f} s)")
    print(f"bpt_tpu_torch plain route: rays {tc[0]} ({(tc[0] - jc[0]) / jc[0] * 100:+.4f}%), "
          f"shadow rays {tc[1]} ({(tc[1] - jc[1]) / jc[1] * 100:+.4f}%), mean radiance "
          f"{tc[2]:.6f} ({(tc[2] - jc[2]) / jc[2] * 100:+.4f}%) ({t2 - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
