"""Cost and effect of building the PT kernel with -fmad=false, on one card.

Builds the kernel twice, with the package's flags (``-fmad=false``) and
with nvcc's default ``a*b+c`` contraction, and runs them in the order
off/on/on/off on the cornell box at 512x512 (one chunk of 2^18 pixels),
16 spp, depth 10, seed 0.  For each run prints the kernel's ms per call
(CUDA events, 5 calls after a warm-up), its rays_traced, and the share of
pixels within rtol 1e-4 / atol 1e-6 of, and bitwise equal to, the
``-fmad=false`` build's radiance.

    python tools/probe_fmad.py
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

    if not torch.cuda.is_available():
        print("probe_fmad: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    scene = cornell_box(device=dev)
    W, S, depth = 512, 4, 10
    cfg = dataclasses.replace(cornell_box_camera(), image_width=W,
                              samples_per_pixel=S * S)
    cam = pk.camera_table(camera_constants(cfg, torch.float32, dev))
    pix = torch.arange(W * W, dtype=torch.int64, device=dev)
    i, j = (pix % W).float(), (pix // W).float()
    args = (scene, i, j, i * 0, j * 0, pix, cam, rng.prng_key(0), depth)

    def run():
        return pk.pt_megakernel_pixels(*args, spp_loop=S * S, sqrt_spp=S)

    flags = {"fmad_false": list(build.NVCC_FLAGS),
             "fmad_true": [f for f in build.NVCC_FLAGS if f != "-fmad=false"]}
    ref = None
    times = {name: [] for name in flags}
    for name in ("fmad_false", "fmad_true", "fmad_true", "fmad_false"):
        build.NVCC_FLAGS[:] = flags[name]
        build._lib = None  # the flags are in the library's hash: another .so
        out = run()
        rad = torch.stack(out[:3], dim=1)
        if ref is None:
            ref = rad
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / 5
        times[name].append(ms)
        ok = ((rad - ref).abs() <= 1e-6 + 1e-4 * ref.abs()).all(dim=1)
        same = (rad == ref).all(dim=1)
        print(f"{name}: {ms:.3f} ms; rays {int(out[3])}; vs -fmad=false: "
              f"{ok.double().mean() * 100:.3f}% within tol, "
              f"{same.double().mean() * 100:.3f}% bitwise ({card})")
    print(times, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
