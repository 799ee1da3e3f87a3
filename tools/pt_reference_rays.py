"""Counters of bpt_tpu's fused PT or BDPT kernel on the cornell box, on a CPU.

For PT, the rays_traced that chip_smoke.py holds the port's 512x512 / 16
spp / depth-10 / seed-0 render to.  Runs bpt_tpu's pt_megakernel_pixels
(or bdpt_megakernel_pixels) in Pallas interpret mode over chunks of
pixels (all strata in-kernel, as the render loop's fused path does) and
sums the kernel's own counters.  At the default configuration PT takes
about ten minutes on one core, BDPT longer.

    python tools/pt_reference_rays.py [--integrator pt|bdpt|bdpt-mis]
        [--width 512] [--spp 16] [--depth 10] [--seed 0] [--chunk 4096]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--integrator", choices=("pt", "bdpt", "bdpt-mis"), default="pt")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=4096)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from bpt_tpu.models.camera import camera_constants
    from bpt_tpu.ops.pallas import bdpt_kernel as bk
    from bpt_tpu.ops.pallas import pt_kernel as pk
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera

    scene = cornell_box(dtype=jnp.float32)
    cfg = dataclasses.replace(cornell_box_camera(), image_width=args.width,
                              samples_per_pixel=args.spp)
    cam = pk.camera_table(camera_constants(cfg, jnp.float32))
    S = cfg.sqrt_spp
    W, npix = cfg.image_width, cfg.image_width * cfg.image_height
    key = jax.random.PRNGKey(args.seed)
    # rays, shadow rays, node visits, aabb hits, tri tests, tri hits
    rays = np.zeros(6, np.int64)
    for c0 in range(0, npix, args.chunk):
        pix = np.arange(c0, min(c0 + args.chunk, npix), dtype=np.int32)
        i = jnp.asarray((pix % W).astype(np.float32))
        j = jnp.asarray((pix // W).astype(np.float32))
        if args.integrator == "pt":
            out = pk.pt_megakernel_pixels(scene, i, j, i * 0, j * 0, jnp.asarray(pix),
                                          cam, key, args.depth, interpret=True,
                                          spp_loop=S * S, sqrt_spp=S)
            out = (*out[:4], 0, out[4])
        else:
            out = bk.bdpt_megakernel_pixels(scene, i, j, jnp.asarray(pix), cam, key,
                                            args.depth, S, interpret=True,
                                            mis=args.integrator == "bdpt-mis")
        rays += np.array([int(out[3]), int(out[4])] + [int(x) for x in np.asarray(out[5])])
        print(f"pixels {c0}..{pix[-1]}: running rays_traced {rays[0]} "
              f"shadow_rays {rays[1]}", file=sys.stderr, flush=True)
    print(f"rays_traced {rays[0]} shadow_rays {rays[1]} node_visits {rays[2]} "
          f"aabb_hits {rays[3]} triangle_tests {rays[4]} triangle_hits {rays[5]}")


if __name__ == "__main__":
    main()
