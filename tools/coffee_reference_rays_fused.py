"""rays_traced and shadow_rays of the coffee stand-in's fused BDPT and
BDPT-MIS routes on a pixel subset, on a CPU, two ways: bpt_tpu's jnp
estimator (``models.bdpt.bdpt_radiance`` over its BVH walk, its CPU
dispatch) fed the fused megakernel's own stream (the pixels mode's jitter
and every draw word x0 of threefry(slot key, (sample id, 0)) with
``bdpt_kernel._subkeys_bdpt_raygen``'s keys), and the port's plain version
of the fused kernel (``ops.kernels.bdpt_kernel.
bdpt_megakernel_pixels_plain``, the torch wavefront over the torch BVH
walks).  These are the counts ``chip_smoke.py`` holds the walk mode of
``csrc/bdpt_megakernel.cu`` against on the card.

The counts come from bpt_tpu's jnp estimator rather than its clustered
megakernel in interpret mode, which on this scene (2,861 clusters) takes
hours on a CPU; the two agree on ``tests/test_pallas_kernels.py``'s
clustered cases.  Its clustered closest hit can return a farther triangle
than its BVH walk (ROADMAP §3), so counts, not images, are compared.

The configuration is the coffee stand-in's camera at 512x512, 4 spp,
depth 10, seed 0; every ``--stride``-th pixel with all its strata.  At
stride 257 (4,084 samples) it takes a few minutes on a few cores.

    python tools/coffee_reference_rays_fused.py [--stride 257]
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

    from bpt_tpu.models import bdpt as jbdpt
    from bpt_tpu.models.camera import camera_constants, generate_rays
    from bpt_tpu.ops.pallas import bdpt_kernel as jbk
    from bpt_tpu.ops.pallas import pt_kernel as jk
    from bpt_tpu.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models import camera as tcamera
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as tbk
    from bpt_tpu_torch.ops.kernels import pt_kernel as tk
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml as port_load

    with contextlib.redirect_stdout(sys.stderr):
        ls = load_scene_from_yaml(YAML)
        port = port_load(YAML, device="cpu")
    W, S, depth = 512, 2, 10
    spp = S * S
    cfg = dataclasses.replace(ls.camera, image_width=W, aspect_ratio=1.0,
                              samples_per_pixel=spp, max_depth=depth)
    cc = camera_constants(cfg, jnp.float32)
    pix = np.arange(0, W * W, args.stride, dtype=np.int32)
    pixb = np.tile(pix, spp)
    s = np.repeat(np.arange(spp, dtype=np.int32), pix.size)
    ids = jnp.asarray(pixb * spp + s)
    key = jax.random.PRNGKey(0)
    keys = jbk._subkeys_bdpt_raygen(key, depth)
    ru = ids.astype(jnp.uint32)

    def draw(slot):
        bits, _ = jk._threefry2x32(keys[2 * slot], keys[2 * slot + 1], ru, jnp.zeros_like(ru))
        return jk._bits_to_unit_float(bits)

    nt, nls = jbdpt.NT, jbdpt.NLS
    nj = jbk.n_uniform_slots(depth)
    u_gen = jnp.stack([draw(nj), draw(nj + 1), jnp.zeros(ids.shape), jnp.zeros(ids.shape)], -1)
    o3, d3 = generate_rays(cc, *(jnp.asarray(x.astype(np.float32))
                                 for x in (pixb % W, pixb // W, s % S, s // S)), u_gen)
    print(f"{ids.size} samples ({pix.size} pixels x {spp} strata), depth {depth}", flush=True)

    port_cfg = dataclasses.replace(port.camera, image_width=W, aspect_ratio=1.0,
                                   samples_per_pixel=spp, max_depth=depth)
    cam13 = tk.camera_table(tcamera.camera_constants(port_cfg, torch.float32))
    pt_pix = torch.from_numpy(pix.astype(np.int64))
    for integrator in ("bdpt-mis", "bdpt"):
        mis = integrator == "bdpt-mis"
        t0 = time.monotonic()
        fn = jax.jit(lambda o, d: jbdpt.bdpt_radiance(
            ls.scene, o, d, depth, lambda b, n: [draw(b * nt + k) for k in range(n)],
            [draw(depth * nt + k) for k in range(nls)],
            lambda b, n: [draw(depth * nt + nls + b * nt + k) for k in range(n)], mis=mis))
        _, jst = fn(o3, d3)
        t1 = time.monotonic()
        out = tbk.bdpt_megakernel_pixels_plain(
            port.scene, (pt_pix % W).float(), (pt_pix // W).float(), pt_pix, cam13,
            rng.prng_key(0), depth, S, mis=mis)
        t2 = time.monotonic()
        jc = (int(jst.rays_traced), int(jst.shadow_rays))
        tc = (int(out[3]), int(out[4]))
        print(f"{integrator}: bpt_tpu jnp estimator on the fused kernel's stream rays {jc[0]}, "
              f"shadow rays {jc[1]} ({t1 - t0:.1f} s); bpt_tpu_torch's plain fused kernel "
              f"rays {tc[0]} ({(tc[0] - jc[0]) / jc[0] * 100:+.4f}%), shadow rays {tc[1]} "
              f"({(tc[1] - jc[1]) / jc[1] * 100:+.4f}%) ({t2 - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
