"""rays_traced of the coffee stand-in's PT render on a pixel subset, on a
CPU, three ways: bpt_tpu's pt_wave (its Pallas kernels in interpret mode,
the route bpt_tpu's bench takes on a TPU), bpt_tpu's jnp wavefront over
its BVH walk (models.pt.path_trace_radiance on the same kernel stream) and
the port's pt_wave_plain.  Prints each count and the lanes whose radiance
differs between them (rtol 1e-4 / atol 1e-4).

The configuration is bench.py's coffee cell (512x512, 16 spp, depth 10,
seed 0); every ``--stride``-th pixel with all its strata.  At stride 257
(16,336 samples) it takes a few minutes on a few cores.

    python tools/coffee_reference_rays.py [--stride 257]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

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

    from bpt_tpu.core import vec3 as jv3
    from bpt_tpu.models import pt as jpt
    from bpt_tpu.models.camera import camera_constants, generate_rays
    from bpt_tpu.models.render import _raygen_jitter_host
    from bpt_tpu.ops.pallas.pt_wave import pt_wave
    from bpt_tpu.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops.kernels.pt_wave import pt_wave_plain
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml as port_load

    with contextlib.redirect_stdout(sys.stderr):
        ls = load_scene_from_yaml(YAML)
        port_scene = port_load(YAML, device="cpu").scene
    cfg = dataclasses.replace(ls.camera, image_width=512, aspect_ratio=1.0,
                              samples_per_pixel=16, max_depth=10, integrator="pt")
    cc = camera_constants(cfg, jnp.float32)
    W, S, spp = 512, 4, 16
    pix = np.arange(0, W * W, args.stride, dtype=np.int32)
    pixb = np.tile(pix, spp)
    s = np.repeat(np.arange(spp, dtype=np.int32), pix.size)
    ids = pixb * spp + s
    key = jax.random.PRNGKey(0)
    u0, u1 = _raygen_jitter_host(key, jnp.asarray(ids))
    z = jnp.zeros_like(u0)
    o3, d3 = generate_rays(cc, *(jnp.asarray(x.astype(np.float32))
                                 for x in (pixb % W, pixb // W, s % S, s // S)),
                           jnp.stack([u0, u1, z, z], -1))
    kpt = jax.random.fold_in(key, 1)
    print(f"{ids.size} samples ({pix.size} pixels x {spp} strata)", flush=True)

    out = pt_wave(ls.scene, jv3.from_array(o3), jv3.from_array(d3), jnp.asarray(ids),
                  kpt, cfg.max_depth, interpret=True)
    rad = {"bpt_tpu pt_wave (Pallas, interpret)": (np.stack([np.asarray(x) for x in out[:3]], 1),
                                                   int(out[3]))}
    print(f"bpt_tpu pt_wave (Pallas, interpret): rays {int(out[3])}", flush=True)
    jr, st = jpt.path_trace_radiance(
        ls.scene, o3, d3, cfg.max_depth,
        jpt.kernel_stream_uniforms_fn(kpt, jnp.asarray(ids), jnp.float32))
    rad["bpt_tpu jnp wavefront (BVH)"] = (np.asarray(jr), int(st.rays_traced))
    print(f"bpt_tpu jnp wavefront (BVH): rays {int(st.rays_traced)}", flush=True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    po = pt_wave_plain(port_scene, Vec3(*t(o3).unbind(1)), Vec3(*t(d3).unbind(1)),
                       torch.from_numpy(ids), rng.fold_in(rng.prng_key(0), 1),
                       cfg.max_depth)
    rad["bpt_tpu_torch pt_wave_plain"] = (torch.stack(po[:3], 1).numpy(), int(po[3]))
    print(f"bpt_tpu_torch pt_wave_plain: rays {int(po[3])}", flush=True)
    names = list(rad)
    for a in range(len(names)):
        for b in range(a + 1, len(names)):
            ra, rb = rad[names[a]][0], rad[names[b]][0]
            diff = ~np.isclose(ra, rb, rtol=1e-4, atol=1e-4).all(1)
            na, nb = rad[names[a]][1], rad[names[b]][1]
            print(f"{names[a]} vs {names[b]}: rays {na} vs {nb} "
                  f"({(na - nb) / nb * 100:+.3f}%), {int(diff.sum())} of {ids.size} "
                  "lanes differ")


if __name__ == "__main__":
    main()
