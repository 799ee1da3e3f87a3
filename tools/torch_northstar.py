"""The north-star on bpt_tpu_torch: the glass stand-in
(scenes/glass/glass_standin.yaml, 510 triangles) at 1920x1080, 1024 spp,
depth 80, seed 0, float32, with pt, bdpt and bdpt-mis, the configuration
tools/run_northstar_bdpt.py renders with bpt_tpu.

    python tools/torch_northstar.py [--size 1920x1080] [--spp 1024] [--depth 80]
        [--device cuda|cpu] [--out-dir output]

It renders on the card (``--device cpu`` runs the kernels' plain versions;
without a card and without it, it exits 2).  It first checks that the
megakernels take the scene (``megakernel_reject_reason`` empty) and that
``render()`` routes each integrator to the fused loop, then renders the
whole image of each integrator through ``models.render.render_part``
(bitwise ``render()``'s framebuffer).  For each it prints a line of its
figures: the wall (first launch to the last synchronize), rays_traced,
shadow_rays, Mrays/s (rays_traced / wall), the launches of
pt_megakernel_pixels, bdpt_megakernel_pixels and strata_sum, the peak
device memory, the means of the 8-bit image and of the linear radiance,
whether the framebuffer is finite and the sha256 of the 8-bit image.  The
comparisons, on the 8-bit tonemapped images in [0, 1]:

- bdpt and bdpt-mis against PT: the RMSE of 8x8 block means and the ratio
  of the means, as run_northstar_bdpt.py computes them, and the ratio of
  the linear radiance's means, over the image and over its upper and
  lower halves of rows;
- PT against the reference binary's tests/golden/ref_binary/
  ref_glass_640_64_d80.png, where the image is k times its 640x360: the
  image's k x k block means (the area of one 640x360 pixel), then the RMSE
  of 8x8 block means of both.

The last line is one JSON object of every figure.  Exits 1 if a
framebuffer is not finite or PT's RMSE against the binary is over 1.5%.
Writes each image to ``<out-dir>/northstar_<integrator>.png``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from torch_northstar_glass import BOUND, GOLDEN, SCENE, downsampled_rmse  # noqa: E402

INTEGRATORS = ("pt", "bdpt", "bdpt-mis")
REF_SIZE = (640, 360)  # the binary's golden
SEED = 0


def block_means(x: np.ndarray, f: int) -> np.ndarray:
    """Means of the f x f blocks of [H, W, 3] (H, W cut to multiples of f)."""
    h, w = x.shape[0] // f * f, x.shape[1] // f * f
    return x[:h, :w].reshape(h // f, f, w // f, f, 3).mean((1, 3))


def ref_area(width: int, height: int) -> int:
    """k where the image is k times the golden's 640x360, else 0."""
    k = width // REF_SIZE[0]
    return k if k >= 1 and (width, height) == (k * REF_SIZE[0], k * REF_SIZE[1]) else 0


def rmse_vs_ref(img8: np.ndarray, ref8: np.ndarray, area: int) -> float:
    """8x8-downsampled RMSE in [0, 1] of ``img8``'s ``area`` x ``area``
    block means against the 8-bit ``ref8`` (``area`` times smaller)."""
    return downsampled_rmse(block_means(np.asarray(img8, np.float64), area), ref8)


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def render_whole(scene, cfg, integ, seed, dev):
    """(8-bit image, framebuffer sum [H, W, 3], wall, stats, launches, peak
    bytes) of the whole image through render_part on the fused route."""
    import torch

    from bpt_tpu_torch.models import render as mr
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk

    wrappers = (pk.pt_megakernel_pixels, bk.bdpt_megakernel_pixels, pk.strata_sum)
    for fn in wrappers:
        fn.launches = 0
    W, H = cfg.image_width, cfg.image_height
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    fb, counts = mr.render_part(scene, cfg, seed, integ, "fused", 0, W * H)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    fbn = fb.cpu().numpy().reshape(H, W, 3)
    img = mr.RenderResult(fbn, cfg.effective_spp, None, W, H).rgb8()
    stats = mr.counts_to_stats(counts, scene, wall)
    return img, fbn, wall, stats, {fn.__name__: fn.launches for fn in wrappers}, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=80)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out-dir", default="output")
    args = ap.parse_args(argv)

    import torch

    from bpt_tpu_torch.models import render as mr
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.utils.png import read_png, write_png

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_northstar: no CUDA card (pass --device cpu to run the plain versions)",
              file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    W, H = (int(x) for x in args.size.split("x"))
    loaded = load_scene_from_yaml(SCENE, dtype=torch.float32, device=dev, verbose=False)
    scene = loaded.scene
    cfg = dataclasses.replace(loaded.camera, image_width=W, aspect_ratio=W / H,
                              samples_per_pixel=args.spp, max_depth=args.depth)
    if cfg.image_height != H:
        print(f"torch_northstar: --size {args.size} gives height {cfg.image_height}",
              file=sys.stderr)
        return 2
    card = card_line(dev)
    print(card, flush=True)
    if dev.type == "cuda":  # the build is no part of a render's wall
        from bpt_tpu_torch.ops.kernels import build

        t0 = time.monotonic()
        build.load_library()
        print(f"kernels built and loaded in {time.monotonic() - t0:.1f} s", flush=True)
    for integ in INTEGRATORS:
        reason = pk.megakernel_reject_reason(scene, integ)
        route = mr._route(scene, dataclasses.replace(cfg, integrator=integ), integ, None)
        print(f"{integ}: {scene.num_tris} triangles, megakernel_reject_reason {reason!r}, "
              f"route {route}", flush=True)
        if reason or route != "fused":
            print(f"torch_northstar: {integ} does not take the fused megakernels",
                  file=sys.stderr)
            return 1
    area = ref_area(W, H)
    figures, images = {}, {}
    for integ in INTEGRATORS:
        img, fbn, wall, st, launches, peak = render_whole(scene, cfg, integ, SEED, dev)
        images[integ] = img
        if integ == "pt":
            linear_pt = fbn
        write_png(f"northstar_{integ}.png", img, args.out_dir)
        m = {"wall_s": wall, "rays_traced": st.rays_traced, "shadow_rays": st.shadow_rays,
             "mrays_per_s": st.rays_traced / wall / 1e6, "launches": launches,
             "peak_bytes": peak, "mean_8bit": float(img.mean()),
             "mean_linear": float(fbn.mean(dtype=np.float64)) / cfg.effective_spp,
             "finite": bool(np.isfinite(fbn).all()),
             "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
        if integ == "pt":
            m["rmse_vs_ref"] = rmse_vs_ref(img, read_png(GOLDEN), area) if area else None
        else:
            pt = figures["pt"]
            m["rmse_vs_pt"] = downsampled_rmse(img, images["pt"])
            m["mean_ratio_vs_pt"] = m["mean_8bit"] / pt["mean_8bit"]
            m["linear_ratio_vs_pt"] = m["mean_linear"] / pt["mean_linear"]
            halves = [(fbn[r].mean(dtype=np.float64), linear_pt[r].mean(dtype=np.float64))
                      for r in (slice(0, H // 2), slice(H // 2, H))]
            m["linear_ratio_vs_pt_halves"] = [float(a / b) if b > 0 else None
                                              for a, b in halves]
        figures[integ] = m
        print(f"{integ}: " + ", ".join(f"{k} {v}" for k, v in m.items()), flush=True)
    ok = all(m["finite"] for m in figures.values())
    if figures["pt"]["rmse_vs_ref"] is not None:
        ok = ok and figures["pt"]["rmse_vs_ref"] <= BOUND
    print(json.dumps({"northstar": figures, "size": [W, H], "spp": cfg.effective_spp,
                      "depth": args.depth, "seed": SEED, "device": card, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
