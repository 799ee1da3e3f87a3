"""CLI entry point of the PyTorch + CUDA port.

Mirrors ``python -m bpt_tpu.render``: no scene argument renders the
built-in cornell box with the preset's integrator, BDPT; a YAML scene
loads with its OBJ meshes and camera.  ``--device`` picks where the render
runs: ``cuda`` (the default) launches the CUDA kernels, ``cpu`` runs their
plain PyTorch versions.  Every scene renders with pt, bdpt and bdpt-mis:
the coffee stand-in's YAML (91,540 triangles) with its own BDPT default,
the textured ``scenes/earth.yaml`` and ``scenes/cornell_smoke.yaml`` with
its two constant-density volumes.
``--f64`` renders the preset or YAML scene in float64, as ``bpt_tpu``'s
CLI does, through the stratum loop, on the card as on the CPU: every scene,
its hits from the float64 instantiations of the brute-force kernels
(``closest_tri`` / ``any_tri``, up to 256 triangles) or of the BVH walks
(``closest_bvh`` / ``any_bvh``, a scene with a BVH).

Usage:
    python -m bpt_tpu_torch.render [scene.yaml] [--spp N] [--size WxH]
        [--integrator pt|bdpt|bdpt-mis] [--max-depth N] [--output FILE]
        [--seed N] [--checkpoint FILE] [--f64] [--no-progress]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", nargs="?", default=None, help="YAML scene file")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--size", type=str, default=None, help="WxH")
    ap.add_argument("--integrator", choices=("pt", "bdpt", "bdpt-mis"), default=None)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--output", type=str, default=None)
    ap.add_argument("--output-dir", type=str, default="output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="npz path for save/resume")
    ap.add_argument("--f64", action="store_true",
                    help="double precision: every scene, through the stratum loop "
                         "(float64 hit kernels on the card)")
    ap.add_argument("--no-progress", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to render: the CUDA kernel or its plain "
                         "PyTorch version on the CPU")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bpt_tpu_torch: CUDA is not available; pass --device cpu to "
              "render with the kernel's plain PyTorch version", file=sys.stderr)
        return 2
    dtype = torch.float64 if args.f64 else torch.float32

    from bpt_tpu_torch.models.render import render
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera
    from bpt_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from bpt_tpu_torch.utils.png import write_png

    overrides = {}
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.max_depth is not None:
        overrides["max_depth"] = args.max_depth
    if args.integrator is not None:
        overrides["integrator"] = args.integrator
    if args.output is not None:
        overrides["file_name"] = args.output
    if args.size is not None:
        try:
            w, h = (int(x) for x in args.size.lower().split("x"))
            if w <= 0 or h <= 0:
                raise ValueError
        except ValueError:
            ap.error(f"--size must be WxH (e.g. 1280x720), got {args.size!r}")
        overrides["image_width"] = w
        overrides["aspect_ratio"] = w / h

    if args.scene:
        from bpt_tpu_torch.scene.loader import load_scene_from_yaml

        try:
            loaded = load_scene_from_yaml(args.scene, dtype=dtype, device=args.device)
        except Exception as ex:  # the reference prints and exits 1
            print(f"Failed to load scene: {ex}", file=sys.stderr)
            return 1
        scene = loaded.scene
        cfg = dataclasses.replace(loaded.camera, **overrides)
    else:
        scene = cornell_box(dtype=dtype, device=args.device)
        cfg = dataclasses.replace(cornell_box_camera(), **overrides)

    resume = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        resume = load_checkpoint(args.checkpoint)
        print(f"Resuming from {args.checkpoint} "
              f"({resume['strata_done']} units done)", file=sys.stderr)

    cb = None
    if args.checkpoint:
        cb = lambda state: save_checkpoint(args.checkpoint, state)  # noqa: E731

    try:
        result = render(
            scene,
            cfg,
            seed=args.seed,
            chunk_size=args.chunk_size,
            progress=not args.no_progress,
            resume=resume,
            stratum_callback=cb,
        )
    except NotImplementedError as ex:
        print(ex, file=sys.stderr)
        return 1
    path = write_png(cfg.file_name, result.rgb8(), output_dir=args.output_dir)
    print(result.stats.summary(), file=sys.stderr)
    print(f"Wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
