"""Peak device memory per ray of one large-scene BDPT wave, on one NVIDIA
card: ``models.bdpt.bdpt_jnp`` (the BDPT wave loop's estimator) over the
coffee stand-in
(scenes/coffee/coffee_standin.yaml) for waves of the render loop's own
primary rays at several depths, bdpt and bdpt-mis.  For each it prints the
peak of ``torch.cuda.max_memory_allocated`` above the memory held before
the wave, per ray, the peak reserved by the allocator, and the wave's
seconds; then the least-squares fit of bytes per ray = a*S^2 + b*S + c
over the depths S (a = 0 without MIS), the form of
``models/render.py::BYTES_PER_RAY``.  With ``--render-depth N`` it then
renders the coffee stand-in at 512x512, 4 spp, depth N with bdpt-mis
through the BDPT wave loop (``models.render._render_strata`` with
``bdpt_wave``, which ``render()`` takes to depth 32) and prints the wave
shape the budget chose, the render's wall and its peak device memory against
``BDPT_WAVE_BYTES``.  ``--f64`` does the same in float64, where every
BDPT render takes the stratum loop (``_render_strata`` without
``bdpt_wave``, ``bdpt_fast`` falling through to ``bdpt_jnp``): the scene,
the camera and the rays in float64, the fit that of
``BYTES_PER_RAY[torch.float64]``, the render the float64 route's.

    python tools/probe_bdpt_wave_memory.py [--rays 65536] [--depths 2,5,10,20]
        [--render-depth 80] [--f64]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes",
                    "coffee", "coffee_standin.yaml")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--depths", type=str, default="2,5,10,20")
    ap.add_argument("--render-depth", type=int, default=0)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models.bdpt import bdpt_jnp
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.models import render as render_mod
    from bpt_tpu_torch.models.render import jnp_raygen
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml

    if not torch.cuda.is_available():
        print("probe_bdpt_wave_memory: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    dtype = torch.float64 if args.f64 else torch.float32
    loaded = load_scene_from_yaml(YAML, device=dev, dtype=dtype, verbose=False)
    cfg = dataclasses.replace(loaded.camera, image_width=512, aspect_ratio=1.0,
                              samples_per_pixel=4)
    cc = camera_constants(cfg, dtype, dev)
    B = args.rays
    pix = torch.arange(B, dtype=torch.int64, device=dev) % (512 * 512)
    s = torch.arange(B, dtype=torch.int64, device=dev) // (512 * 512)
    key = rng.prng_key(0)
    o, d, ids = jnp_raygen(cc, pix, s, key, dtype)
    depths = [int(x) for x in args.depths.split(",")]
    print(f"{card}; coffee stand-in in {dtype}, {B} rays a wave")
    for mis in (False, True):
        per_ray = []
        for depth in depths:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.monotonic()
            rad, st = bdpt_jnp(loaded.scene, o, d, ids, key, depth, mis=mis)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated(dev) - base
            reserved = torch.cuda.max_memory_reserved(dev)
            per_ray.append(peak / B)
            print(f"{'bdpt-mis' if mis else 'bdpt'} depth {depth}: peak {peak / 2**20:.1f} MiB "
                  f"above the {base / 2**20:.1f} MiB held, {peak / B:.1f} B a ray; allocator "
                  f"reserved {reserved / 2**20:.1f} MiB; {secs:.3f} s; rays {int(st.rays_traced)},"
                  f" shadow rays {int(st.shadow_rays)}", flush=True)
            del rad, st
            torch.cuda.empty_cache()
        S = np.asarray(depths, np.float64)
        cols = [S * S, S, np.ones_like(S)] if mis else [S, np.ones_like(S)]
        coef = np.linalg.lstsq(np.stack(cols, 1), np.asarray(per_ray), rcond=None)[0]
        fit = ([0.0] if not mis else []) + coef.tolist()
        worst = max(p / (fit[0] * x * x + fit[1] * x + fit[2])
                    for p, x in zip(per_ray, depths))
        print(f"{'bdpt-mis' if mis else 'bdpt'}: bytes a ray ~ {fit[0]:.2f}*S^2 + "
              f"{fit[1]:.2f}*S + {fit[2]:.2f} (worst measured / fit {worst:.3f})", flush=True)
    if args.render_depth:
        del o, d, ids
        torch.cuda.empty_cache()
        depth = args.render_depth
        rcfg = dataclasses.replace(cfg, max_depth=depth)
        strata, span = render_mod._bdpt_wave_shape(512 * 512, 4, depth, True, dtype)
        a, b, c = render_mod.BYTES_PER_RAY[dtype][True]
        budget = render_mod.BDPT_WAVE_BYTES
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fb = torch.zeros((512 * 512, 3), dtype=dtype, device=dev)
        t0 = time.monotonic()
        rays, shadow, _ = render_mod._render_strata(
            loaded.scene, rcfg, camera_constants(rcfg, dtype, dev), "bdpt-mis", 0, fb,
            None, None, None, bdpt_wave=not args.f64)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        fb = fb.cpu().numpy()
        print(f"render bdpt-mis 512x512, 4 spp, depth {depth} in {dtype}: waves of {strata} strata x "
              f"{span} pixels ({a * depth * depth + b * depth + c} budgeted bytes a ray); "
              f"wall {wall:.3f} s; peak {peak / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held, {peak / (strata * span):.1f} B a ray, "
              f"{peak / budget * 100:.1f}% of BDPT_WAVE_BYTES ({budget / 2**30:.0f} GiB); "
              f"allocator reserved {torch.cuda.max_memory_reserved(dev) / 2**30:.3f} GiB; "
              f"rays {int(rays)}, shadow rays {int(shadow)}; image finite "
              f"{bool(np.isfinite(fb).all())}, mean {float(fb.mean()):.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
