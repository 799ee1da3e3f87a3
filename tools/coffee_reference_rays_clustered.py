"""rays_traced and shadow_rays of the coffee stand-in's BDPT-MIS render on
a pixel subset through the clustered hit kernels, on a CPU, two ways:
bpt_tpu's TPU route for them forced on a CPU (its jnp BDPT wavefront,
``models.bdpt.bdpt_fast``, over ``ops.soa``'s clustered dispatch with
``_on_tpu`` true and the Pallas kernels 10-13 in interpret mode) and the
port's plain version of the same route (``models.bdpt.bdpt_jnp`` over
``ops.soa``'s card dispatch, taken on a CPU scene, through the plain
versions of ``ops/kernels/cluster_wave.py`` and ``ops/kernels/plucker.py``).
Each under one of bpt_tpu's switches: ``BPT_TPU_NO_FTB=1`` (the rolled
kernels 10-11) and ``BPT_TPU_WAVE_IMPL=plucker`` (kernels 12-13).  Prints
each count, the samples whose radiance differs between them (rtol 1e-4 /
atol 1e-4), and bpt_tpu's BVH route for comparison (``--bvh``).

The configuration is bench.py's coffee BDPT cell (512x512, 4 spp, depth
10, seed 0, bdpt-mis); every ``--stride``-th pixel with all its strata.

    python tools/coffee_reference_rays_clustered.py [--stride 257] [--bvh]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes",
                    "coffee", "coffee_standin.yaml")
SWITCHES = (("BPT_TPU_NO_FTB", "1"), ("BPT_TPU_WAVE_IMPL", "plucker"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stride", type=int, default=257)
    ap.add_argument("--bvh", action="store_true", help="also bpt_tpu's CPU route (BVH walk)")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from bpt_tpu.core import rng as jrng
    from bpt_tpu.models import bdpt as jbdpt
    from bpt_tpu.models.camera import camera_constants, generate_rays
    from bpt_tpu.ops import soa as jsoa
    from bpt_tpu.ops.pallas import cluster_wave as jcw
    from bpt_tpu.ops.pallas import clusters as jcl
    from bpt_tpu.ops.pallas import plucker as jpl
    from bpt_tpu.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models import bdpt as tbdpt
    from bpt_tpu_torch.models import camera as tcamera
    from bpt_tpu_torch.models.render import jnp_raygen
    from bpt_tpu_torch.ops import soa as tsoa
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml as port_load

    def impls():  # bpt_tpu's _wave_impls, its kernels in interpret mode
        if os.environ.get("BPT_TPU_WAVE_IMPL", "roll") == "plucker":
            return (jpl.pack_plucker_clusters,
                    functools.partial(jpl.plucker_closest_pallas, interpret=True),
                    functools.partial(jpl.plucker_any_pallas, interpret=True))
        return (jcl.pack_clusters_rolled,
                functools.partial(jcw.clustered_closest_pallas, interpret=True),
                functools.partial(jcw.clustered_any_pallas, interpret=True))

    with contextlib.redirect_stdout(sys.stderr):
        ls = load_scene_from_yaml(YAML)
        loaded = port_load(YAML, device="cpu", verbose=False)
    port_scene = loaded.scene
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
    port_cfg = dataclasses.replace(loaded.camera, image_width=W, aspect_ratio=1.0,
                                   samples_per_pixel=S * S, max_depth=depth)
    po, pd, pids = jnp_raygen(tcamera.camera_constants(port_cfg, torch.float32),
                              torch.from_numpy(pixb.astype(np.int64)),
                              torch.from_numpy(s.astype(np.int64)), rng.prng_key(0),
                              torch.float32)
    print(f"{ids.size} samples ({pix.size} pixels x {S * S} strata), depth {depth}, "
          f"bdpt-mis", flush=True)

    def jax_run():
        fn = jax.jit(lambda o, d, i: jbdpt.bdpt_fast(ls.scene, o, d, i, key, depth, mis=True))
        r, st = fn(o3, d3, jnp.asarray(ids))
        return np.asarray(r), (int(st.rays_traced), int(st.shadow_rays))

    if args.bvh:
        t0 = time.monotonic()
        _, jc = jax_run()
        print(f"bpt_tpu CPU route (BVH walk): rays {jc[0]}, shadow rays {jc[1]} "
              f"({time.monotonic() - t0:.1f} s)", flush=True)

    card_bvh, on_tpu, wave_impls = tsoa._card_bvh, jsoa._on_tpu, jsoa._wave_impls
    tsoa._card_bvh = lambda scene: scene.use_bvh
    jsoa._on_tpu, jsoa._wave_impls = (lambda: True), impls
    try:
        for var, val in SWITCHES:
            os.environ[var] = val
            try:
                t0 = time.monotonic()
                jr, jc = jax_run()
                t1 = time.monotonic()
                tr, tst = tbdpt.bdpt_jnp(port_scene, po, pd, pids, rng.prng_key(0), depth,
                                         mis=True)
                t2 = time.monotonic()
            finally:
                del os.environ[var]
            tc = (int(tst.rays_traced), int(tst.shadow_rays))
            diff = ~np.isclose(tr.numpy(), jr, rtol=1e-4, atol=1e-4).all(1)
            print(f"{var}={val}: bpt_tpu's TPU route on a CPU (interpret mode) rays {jc[0]}, "
                  f"shadow rays {jc[1]} ({t1 - t0:.1f} s); bpt_tpu_torch plain route rays "
                  f"{tc[0]} ({(tc[0] - jc[0]) / jc[0] * 100:+.4f}%), shadow rays {tc[1]} "
                  f"({(tc[1] - jc[1]) / jc[1] * 100:+.4f}%) ({t2 - t1:.1f} s); "
                  f"{int(diff.sum())} of {ids.size} samples differ", flush=True)
    finally:
        tsoa._card_bvh, jsoa._on_tpu, jsoa._wave_impls = card_bvh, on_tpu, wave_impls


if __name__ == "__main__":
    main()
