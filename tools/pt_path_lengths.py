"""Path lengths of the cornell PT main path's chunk, and what they cost a warp.

    python tools/pt_path_lengths.py [--device cuda|cpu] [--width 512] [--spp 16]
        [--depth 10] [--seed 0] [--chunk 65536]

Runs the plain PT estimator (``models.pt.pt_bounce`` over
``ops.soa.closest_hit``, plain) on the stream of the brute-force PT
megakernel's pixels mode (``pt_kernel.pt_megakernel_pixels_plain``'s rays
and draws) and counts, for every sample (pixel, stratum), the bounces its
path runs: the iterations of the kernel's bounce loop, whose paths end on a
miss, an emitter, a mixture pdf of 0 or the depth.  Then, for warps of 32
consecutive pixels:

- lockstep: each thread runs its pixel's strata one after another and the
  warp reconverges after each stratum, so a stratum costs the warp its
  longest path (the sum over strata of the warp's longest path);
- flat: each thread runs one bounce of its current sample an iteration and
  starts its next stratum as soon as a path ends (the warp's largest sum
  of a lane's path lengths);
- useful: the mean over the warp's lanes of those sums.

And for the rays mode, one path a thread (a warp of 32 consecutive pixels
of one stratum): the warp's longest path against the mean.  Prints the
iterations a warp takes on average under each, the lane efficiency
(useful / schedule), the mean path length and the rays the counts give
(the estimator's rays_traced: the bounces plus the paths that reach the
depth), and a histogram of the lengths.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def path_lengths(scene, cam13, key, width, sqrt_spp, depth, dev, chunk):
    """[spp, width*width] int16: the bounces each sample's path runs, and the
    count of paths that reach the depth (which count one ray more)."""
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core import vec3 as v3
    from bpt_tpu_torch.models.camera import generate_rays
    from bpt_tpu_torch.models.pt import NU, kernel_stream_uniforms_fn, pt_bounce
    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.ops.intersect import T_MIN
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk

    spp, n_pix = sqrt_spp * sqrt_spp, width * width
    cc = pk._camera_from_table(cam13)
    key_pt = rng.fold_in(key, 1)
    lengths = torch.zeros((spp, n_pix), dtype=torch.int16)
    exhausted = 0
    for k in range(spp):
        for p0 in range(0, n_pix, chunk):
            pix = torch.arange(p0, min(n_pix, p0 + chunk), device=dev)
            rid = pix * spp + k
            i, j = (pix % width).float(), (pix // width).float()
            u0, u1 = rng.raygen_jitter(key, rid)
            z = torch.zeros_like(u0)
            origins, dirs = generate_rays(cc, i, j, torch.full_like(i, float(k % sqrt_spp)),
                                          torch.full_like(i, float(k // sqrt_spp)),
                                          torch.stack([u0, u1, z, z], -1))
            ufn = kernel_stream_uniforms_fn(key_pt, rid, origins.dtype)
            o, d = v3.from_array(origins), v3.from_array(dirs)
            thr = v3.Vec3(*(torch.ones_like(i) for _ in range(3)))
            alive = torch.ones_like(i, dtype=torch.bool)
            n = torch.zeros_like(pix)
            for b in range(depth):
                n += alive
                h = soa.closest_hit(scene, o, d, T_MIN, torch.inf, mask=alive, plain=True)
                o, d, thr, _, alive = pt_bounce(scene, o, d, thr, alive, h, ufn(b, NU))
            exhausted += int(alive.sum())
            lengths[k, p0:p0 + pix.numel()] = n.to(torch.int16).cpu()
    return lengths, exhausted


def warp_costs(lengths):
    """(lockstep, flat, useful) iterations of each warp of 32 consecutive
    pixels, and (longest, mean) of each rays-mode warp: numpy arrays."""
    import numpy as np

    n = lengths.numpy().astype(np.int64)  # [spp, pixels]
    spp, n_pix = n.shape
    w = n[:, :n_pix // 32 * 32].reshape(spp, -1, 32)  # [spp, warps, lane]
    lockstep = w.max(axis=2).sum(axis=0)
    per_lane = w.sum(axis=0)  # [warps, lane]
    return (lockstep, per_lane.max(axis=1), per_lane.mean(axis=1),
            w.max(axis=2).ravel(), w.mean(axis=2).ravel())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=65536)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("pt_path_lengths: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    sqrt_spp = int(round(args.spp ** 0.5))
    if sqrt_spp * sqrt_spp != args.spp:
        print(f"pt_path_lengths: --spp {args.spp} is not a square", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    scene = cornell_box(device=dev)
    cfg = dataclasses.replace(cornell_box_camera(), image_width=args.width,
                              samples_per_pixel=args.spp)
    cam13 = pk.camera_table(camera_constants(cfg, torch.float32, dev))
    lengths, exhausted = path_lengths(scene, cam13, rng.prng_key(args.seed), args.width,
                                      sqrt_spp, args.depth, dev, args.chunk)
    lock, flat, useful, r_long, r_mean = warp_costs(lengths)
    n = lengths.numpy().astype(np.int64)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(f"cornell PT {args.width}x{args.width} x {args.spp} spp, depth {args.depth}, seed "
          f"{args.seed}, plain estimator on {where}, {time.monotonic() - t0:.1f} s")
    print(f"samples {n.size}, mean path length {n.mean():.4f} bounces, rays "
          f"{int(n.sum()) + exhausted} ({exhausted} paths reach the depth)")
    hist = np.bincount(n.ravel(), minlength=args.depth + 1)
    print("histogram of path lengths: " + ", ".join(
        f"{b}: {c}" for b, c in enumerate(hist.tolist()) if c))
    print(f"pixels mode, {lock.size} warps of 32 pixels, iterations a warp: lockstep "
          f"{lock.mean():.3f}, flat {flat.mean():.3f}, useful {useful.mean():.3f}; "
          f"lane efficiency lockstep {useful.sum() / lock.sum() * 100:.2f}%, flat "
          f"{useful.sum() / flat.sum() * 100:.2f}%")
    print(f"rays mode, {r_long.size} warps of 32 paths: iterations a warp {r_long.mean():.4f}, "
          f"useful {r_mean.mean():.4f}; lane efficiency {r_mean.sum() / r_long.sum() * 100:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
