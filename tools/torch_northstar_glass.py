"""The glass north-star on bpt_tpu_torch: the glass stand-in
(scenes/glass/glass_standin.yaml, 510 triangles, a dielectric stack) at
640x360, 64 spp, depth 80, PT, seed 0, against the C++ reference binary's
render of the same configuration, tests/golden/ref_binary/
ref_glass_640_64_d80.png, which the binary computes in double.

    python tools/torch_northstar_glass.py [--dtype f32|f64|both] [--out-dir output]

It renders on the card.  For each type it renders through ``render()`` and prints the route, the
kernel launches and plain-version calls, the wall (host clock to the end of
the render's own synchronisation), rays_traced and Mrays/s, and the RMSE of
the two images downsampled 8x8 (box means of the 8-bit tonemapped PNGs, in
[0, 1]), the measure tests/test_ref_rmse.py applies to bpt_tpu; bpt_tpu
recorded 0.87% there.  Float32 takes the brute-force PT megakernel (510 <=
512 triangles; the tool first checks that ``megakernel_reject_reason`` is
empty), float64 the stratum loop over the float64 BVH walk kernels (the
scene has a BVH over 256 triangles).  A render passes at RMSE <= 1.5%.
Writes output/northstar_glass_{f32,f64}.png and prints one JSON line last;
exits 1 if a render is over the bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(ROOT, "tests", "golden", "ref_binary", "ref_glass_640_64_d80.png")
SCENE = os.path.join(ROOT, "scenes", "glass", "glass_standin.yaml")
BOUND = 0.015
# the golden's configuration
WIDTH, HEIGHT, SPP, MAX_DEPTH, SEED = 640, 360, 64, 80, 0
sys.path.insert(0, ROOT)


def downsampled_rmse(ours: np.ndarray, ref: np.ndarray, f: int = 8) -> float:
    """RMSE of the two 8-bit images' f x f box means, in [0, 1]."""

    def ds(x):
        h, w = x.shape[0] // f * f, x.shape[1] // f * f
        return x[:h, :w].reshape(h // f, f, w // f, f, 3).mean((1, 3))

    a, b = (np.asarray(x, np.float64) / 255.0 for x in (ours, ref))
    return float(np.sqrt(((ds(a) - ds(b)) ** 2).mean()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("f32", "f64", "both"), default="both")
    ap.add_argument("--out-dir", default="output")
    args = ap.parse_args(argv)

    import torch

    from bpt_tpu_torch.models import render as mr
    from bpt_tpu_torch.ops.kernels import intersect as ki
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.ops.kernels import pt_wave as pw
    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.utils.png import read_png, write_png

    if not torch.cuda.is_available():
        print("torch_northstar_glass: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    ref = read_png(GOLDEN)
    wrappers = (pk.pt_megakernel, pk.pt_megakernel_pixels, pk.strata_sum, pw.closest_bvh,
                pw.any_bvh, ki.closest_tri, ki.any_tri)
    plains = (soa.bvh_closest, soa.bvh_any, pk.pt_megakernel_plain,
              pk.pt_megakernel_pixels_plain)
    card = torch.cuda.get_device_name(0)
    results = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        if args.dtype not in (name, "both"):
            continue
        loaded = load_scene_from_yaml(SCENE, dtype=dtype, device=dev, verbose=False)
        scene = loaded.scene
        cfg = dataclasses.replace(loaded.camera, aspect_ratio=WIDTH / HEIGHT,
                                  image_width=WIDTH, samples_per_pixel=SPP,
                                  max_depth=MAX_DEPTH, integrator="pt")
        reason = pk.megakernel_reject_reason(scene, "pt")
        route = mr._route(scene, cfg, "pt", None)
        print(f"{name}: {scene.num_tris} triangles, BVH {scene.use_bvh}, "
              f"megakernel_reject_reason {reason!r}, route {route}", flush=True)
        if dtype == torch.float32 and reason:
            print("torch_northstar_glass: the megakernels refuse the float32 glass scene",
                  file=sys.stderr)
            return 1
        for fn in wrappers:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        t0 = time.monotonic()
        res = mr.render(scene, cfg, seed=SEED)
        wall = time.monotonic() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers if fn.launches}
        f64_launches = {fn.__name__: fn.f64_launches for fn in (pw.closest_bvh, pw.any_bvh)
                        if fn.f64_launches}
        calls = {fn.__name__: fn.calls for fn in plains if fn.calls}
        img = res.rgb8()
        write_png(f"northstar_glass_{name}.png", img, args.out_dir)
        rmse = downsampled_rmse(img, ref)
        st = res.stats
        results[name] = {
            "route": route, "wall_s": wall, "render_wall_s": st.wall_seconds,
            "rays_traced": st.rays_traced, "mrays_per_s": st.rays_traced / wall / 1e6,
            "rmse_downsampled": rmse, "launches": launches, "f64_launches": f64_launches,
            "plain_calls": calls, "finite": bool(np.isfinite(res.framebuffer_sum).all()),
            "mean_8bit": float(img.mean()), "ref_mean_8bit": float(ref.mean()),
        }
        print(f"{name}: {WIDTH}x{HEIGHT} {SPP} spp depth {MAX_DEPTH} seed {SEED}: wall "
              f"{wall:.3f} s, rays {st.rays_traced}, "
              f"{st.rays_traced / wall / 1e6:.2f} Mrays/s, downsampled RMSE {rmse:.5f} "
              f"(bound {BOUND}), launches {launches}, float64 launches {f64_launches}, "
              f"plain calls {calls} ({card})", flush=True)
    ok = all(r["finite"] and r["rmse_downsampled"] <= BOUND for r in results.values())
    print(json.dumps({"device": card, "size": [WIDTH, HEIGHT], "spp": SPP,
                      "max_depth": MAX_DEPTH, "seed": SEED, "ok": ok,
                      "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
