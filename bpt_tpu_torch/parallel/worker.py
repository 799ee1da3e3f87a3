"""One process of a multi-process render (``bpt_tpu.parallel.worker``'s
flags, with ``--device`` and ``--backend`` for its ``--local-devices``).

Started by ``bpt_tpu_torch.parallel.multiprocess.launch_local`` (or one a
host on a cluster).  Joins the process group, renders the scene sharded
over the ranks (pixels: ``render_multiprocess``; samples: strata over the
ranks summed with ``dist.all_reduce``), and lets rank 0 write the image:
``.npy`` holds the raw sample sum, bit-comparable across process counts,
``.png`` the tonemapped image.  Every rank prints one line with its
device, wall and the launches of each kernel (and the calls of each plain
version) in this process.

    python -m bpt_tpu_torch.parallel.worker --process-id 0 --num-processes 2 \\
        --coordinator localhost:29500 --device cpu \\
        --size 32x32 --spp 4 --max-depth 3 --output output/fb.npy
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def launch_counts() -> tuple[dict, dict]:
    """(launches of each kernel wrapper, calls of each plain version) in
    this process, the nonzero ones: the wrappers' ``.launches`` and the
    plain versions' ``.calls``."""
    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.ops.kernels import (
        bdpt_kernel,
        cluster_wave,
        intersect,
        plucker,
        pt_kernel,
        pt_wave,
    )

    launches, calls = {}, {}
    for mod in (pt_kernel, bdpt_kernel, pt_wave, intersect, cluster_wave, plucker, soa):
        for name, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "launches", 0):
                launches[name] = fn.launches
            if callable(fn) and getattr(fn, "calls", 0):
                calls[name] = fn.calls
    return launches, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:29500")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the rank's device: cuda:{process-id % cards}, or the CPU")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default nccl on the card, gloo on the CPU")
    ap.add_argument("--scene", default="cornell",
                    help="scene YAML path, or 'cornell' for the preset")
    ap.add_argument("--size", default="32x32")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=3)
    ap.add_argument("--integrator", default="pt", choices=["pt", "bdpt", "bdpt-mis"])
    ap.add_argument("--fast", default="auto", choices=["auto", "always", "never", "wave"],
                    help="the shards' route (parallel/mesh.py::shard_route)")
    ap.add_argument("--shard", default="pixels", choices=["pixels", "spp"],
                    help="pixels: render_multiprocess; spp: a stratum a rank, "
                         "render_spp_sharded, summed with all_reduce")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output", default="",
                    help=".npy (raw sample sum) or .png (tonemapped); written by rank 0")
    args = ap.parse_args(argv)
    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        ap.error(f"--size must be WxH, got {args.size!r}")

    import numpy as np
    import torch.distributed as dist

    from bpt_tpu_torch.parallel.mesh import render_spp_sharded
    from bpt_tpu_torch.parallel.multiprocess import init_multiprocess, render_multiprocess

    dev = init_multiprocess(args.process_id, args.num_processes,
                            coordinator=args.coordinator, device=args.device,
                            backend=args.backend)
    try:
        if args.scene == "cornell":
            from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

            scene, cfg = cornell_box(device=dev), cornell_box_camera()
        else:
            from bpt_tpu_torch.scene.loader import load_scene_from_yaml

            loaded = load_scene_from_yaml(args.scene, device=dev, verbose=False)
            scene, cfg = loaded.scene, loaded.camera
        cfg = dataclasses.replace(cfg, image_width=w, aspect_ratio=w / h,
                                  samples_per_pixel=args.spp, max_depth=args.max_depth,
                                  integrator=args.integrator)
        if args.shard == "pixels":
            fb, spp, stats = render_multiprocess(scene, cfg, seed=args.seed, fast=args.fast)
            rays, wall = stats.rays_traced, stats.wall_seconds
        else:
            spp, n = cfg.sqrt_spp ** 2, dist.get_world_size()
            fb, rays, wall = 0, 0, 0.0
            for s0 in range(0, spp, n):
                part, stats = render_spp_sharded(scene, cfg, mesh=[dev], seed=args.seed, s0=s0)
                fb, rays, wall = fb + part, rays + stats.rays_traced, wall + stats.wall_seconds
        rank = dist.get_rank()
        launches, calls = launch_counts()
        print(f"[worker {rank}/{args.num_processes}] device={dev} backend={dist.get_backend()} "
              f"shard={args.shard} fb={fb.shape} spp={spp} rays={rays} wall={wall:.6f} s "
              f"launches={json.dumps(launches)} plain_calls={json.dumps(calls)}", flush=True)
        if args.output and rank == 0:
            os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
            if args.output.endswith(".npy"):
                np.save(args.output, fb)
            else:
                import torch

                from bpt_tpu_torch.ops.film import to_rgb8
                from bpt_tpu_torch.utils.png import write_png

                write_png(os.path.abspath(args.output), to_rgb8(torch.from_numpy(fb), spp).numpy())
            print(f"[worker 0] wrote {args.output}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
