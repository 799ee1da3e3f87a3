"""rays_traced and shadow_rays of the coffee stand-in's BDPT and BDPT-MIS
renders on a pixel subset, on a CPU, two ways: bpt_tpu's own route for it
on a CPU (the jnp stratum loop: ``models.bdpt.bdpt_fast``'s jnp branch over
``ops.soa.bvh_closest`` / ``bvh_any``, the jnp raygen) and the port's plain
version of its large-scene BDPT route (``models.render.jnp_raygen`` and
``models.bdpt.bdpt_fast`` over the torch BVH walks).  Prints each count
and the samples whose radiance differs between them (rtol 1e-4 / atol
1e-4).

The configuration is bench.py's coffee BDPT cell (512x512, 4 spp, depth
10, seed 0); every ``--stride``-th pixel with all its strata.  At stride
257 (4,084 samples) it takes a few minutes on a few cores.

    python tools/coffee_reference_rays_bdpt.py [--stride 257]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes",
                    "coffee", "coffee_standin.yaml")


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
    from bpt_tpu.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models import bdpt as tbdpt
    from bpt_tpu_torch.models import camera as tcamera
    from bpt_tpu_torch.models.render import jnp_raygen
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml as port_load

    with contextlib.redirect_stdout(sys.stderr):
        ls = load_scene_from_yaml(YAML)
        port_scene = port_load(YAML, device="cpu").scene
    W, S, depth = 512, 2, 10
    cfg = dataclasses.replace(ls.camera, image_width=W, aspect_ratio=1.0,
                              samples_per_pixel=S * S, max_depth=depth)
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

    port_cfg = dataclasses.replace(port_load(YAML, device="cpu", verbose=False).camera,
                                   image_width=W, aspect_ratio=1.0,
                                   samples_per_pixel=S * S, max_depth=depth)
    po, pd, pids = jnp_raygen(tcamera.camera_constants(port_cfg, torch.float32),
                              torch.from_numpy(pixb.astype(np.int64)),
                              torch.from_numpy(s.astype(np.int64)), rng.prng_key(0),
                              torch.float32)
    print(f"raygen: port - bpt_tpu max |o| {np.abs(po.numpy() - np.asarray(o3)).max():.3e}, "
          f"max |d| {np.abs(pd.numpy() - np.asarray(d3)).max():.3e}", flush=True)

    for integrator in ("bdpt-mis", "bdpt"):
        mis = integrator == "bdpt-mis"
        t0 = time.monotonic()
        fn = jax.jit(lambda o, d, i: jbdpt.bdpt_fast(ls.scene, o, d, i, key, depth, mis=mis))
        jr, jst = fn(o3, d3, jnp.asarray(ids))
        jr = np.asarray(jr)
        t1 = time.monotonic()
        tr, tst = tbdpt.bdpt_fast(port_scene, po, pd, pids, rng.prng_key(0), depth, mis=mis)
        tr = tr.numpy()
        t2 = time.monotonic()
        diff = ~np.isclose(tr, jr, rtol=1e-4, atol=1e-4).all(1)
        jc = (int(jst.rays_traced), int(jst.shadow_rays))
        tc = (int(tst.rays_traced), int(tst.shadow_rays))
        print(f"{integrator}: bpt_tpu CPU route (jnp stratum loop, BVH) rays {jc[0]}, shadow "
              f"rays {jc[1]} ({t1 - t0:.1f} s); bpt_tpu_torch plain route rays {tc[0]} "
              f"({(tc[0] - jc[0]) / jc[0] * 100:+.4f}%), shadow rays {tc[1]} "
              f"({(tc[1] - jc[1]) / jc[1] * 100:+.4f}%) ({t2 - t1:.1f} s); "
              f"{int(diff.sum())} of {ids.size} samples differ", flush=True)


if __name__ == "__main__":
    main()
