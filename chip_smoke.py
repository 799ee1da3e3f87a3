#!/usr/bin/env python3
"""Smoke test of bpt_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernel from bpt_tpu_torch/csrc/ (printing the build seconds and ptxas's
   register report).
2. Holds the kernel against its plain PyTorch version on the card, on the
   same inputs: pt_megakernel with injected uniforms and in RNG mode at
   B = 65,536 rays, depth 10; pt_megakernel_pixels at 64x64 and at the
   main path's chunk shape, 512x512 (2^18 pixels), both 16 spp, depth 10.
   Tolerance rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes (a few paths may
   take another branch on a one-ulp difference; the worst lane is
   printed); the pixels mode's counters must be exact.  Then times kernel
   and plain version at the 512x512 shape.
3. Drives the main path: render() of the cornell box with PT at 512x512,
   16 spp, depth 10, seed 0 — one warm-up and three timed renders.  The
   kernel's launch count must be > 0 and the plain version's 0, and
   rays_traced within 0.01% of 11,506,161: the count of bpt_tpu's own
   fused kernel (pt_megakernel_pixels in interpret mode on a CPU, the
   same configuration, seed and threefry stream, summed over 4096-pixel
   chunks; tools/pt_reference_rays.py).  The TPU runs of
   BENCH_r02..r04.json counted 11,497,620 (-0.074%); git history shows
   the fused PT path on this scene unchanged since the round-4 run, so
   that gap lies between TPU and CPU arithmetic, not in the code.  That
   count is printed, not checked.  Writes output/chip_smoke_cornell_pt.png.

The second-to-last line is a JSON object describing the kernel; the last
is {"ok": true, "device": {...}}.  Any failure exits non-zero, and so does
a machine without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

RTOL, ATOL, MIN_FRAC = 1e-4, 1e-6, 0.999
EXPECTED_RAYS = 11_506_161  # bpt_tpu fused kernel, interpret mode on a CPU
TPU_BENCH_RAYS = 11_497_620  # BENCH_r02..r04.json; printed, not checked


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def agreement(got, want):
    """(fraction of lanes within tolerance on all channels, max abs err,
    index of the lane whose error uses the most of its tolerance) of [B,3]
    kernel vs plain radiance."""
    err = (got - want).abs()
    used = (err / (ATOL + RTOL * want.abs())).max(dim=1).values
    ok = used <= 1.0
    worst = int(used.argmax())
    return float(ok.double().mean()), float(err.max()), worst


def compare(name, kernel_out, plain_out, exact_counts: bool):
    import torch

    got = torch.stack(kernel_out[:3], dim=1)
    want = torch.stack(plain_out[:3], dim=1)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel radiance")
    frac, max_err, worst = agreement(got, want)
    kc = [int(kernel_out[3])] + [int(x) for x in kernel_out[4]]
    pc = [int(plain_out[3])] + [int(x) for x in plain_out[4]]
    print(f"{name}: {frac * 100:.4f}% of {got.shape[0]} lanes within rtol "
          f"{RTOL} / atol {ATOL}; max abs err {max_err:.3e}; worst lane "
          f"{worst}: kernel {got[worst].tolist()} plain {want[worst].tolist()}; "
          f"counters (rays, nodes, aabb, tri tests, tri hits) kernel {kc} "
          f"plain {pc}")
    check(frac >= MIN_FRAC, f"{name}: only {frac:.5f} of lanes agree")
    if exact_counts:
        check(kc == pc, f"{name}: counters differ: kernel {kc} plain {pc}")
    return frac, max_err


def time_ms(fn, reps: int) -> float:
    """Mean ms per call between CUDA events after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.models.pt import NU
    from bpt_tpu_torch.models.render import render
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera
    from bpt_tpu_torch.utils.png import write_png

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- phase 1: build
    t0 = time.monotonic()
    lib_path = build.build()
    build.load_library()
    print(f"phase 1: built {lib_path.name} in {time.monotonic() - t0:.2f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    scene = cornell_box(device=dev)

    # ---- phase 2: kernel vs plain version on the card
    B, depth = 65536, 10
    g = np.random.default_rng(0)
    o = torch.from_numpy(g.uniform(50, 500, (B, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev)
    ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    ubuf = torch.from_numpy(
        g.uniform(size=(depth * NU, B)).astype(np.float32)).to(dev)
    key = rng.prng_key(0)
    for mode, u in (("buffer", ubuf), ("rng", None)):
        kout = pk.pt_megakernel(scene, ov, dv, ids, key, depth, uniforms=u)
        pout = pk.pt_megakernel_plain(scene, ov, dv, ids, key, depth, uniforms=u)
        torch.cuda.synchronize()
        compare(f"phase 2: pt_megakernel {mode} mode B={B} depth={depth}",
                kout, pout, exact_counts=False)
    rays_ms = time_ms(lambda: pk.pt_megakernel(scene, ov, dv, ids, key, depth),
                      reps=10)
    rays_plain_ms = time_ms(lambda: pk.pt_megakernel_plain(
        scene, ov, dv, ids, key, depth), reps=3)
    print(f"phase 2: pt_megakernel rng mode B={B} depth={depth}: kernel "
          f"{rays_ms:.3f} ms, plain {rays_plain_ms:.3f} ms ({card})")

    def pixel_args(width):
        """pt_megakernel_pixels' arguments for a one-chunk render of a
        width x width image, built as models/render.py builds them."""
        cfg = dataclasses.replace(cornell_box_camera(), image_width=width,
                                  samples_per_pixel=S * S)
        cam = pk.camera_table(camera_constants(cfg, torch.float32, dev))
        pix = torch.arange(width * width, dtype=torch.int64, device=dev)
        i = (pix % width).float()
        j = (pix // width).float()
        return (scene, i, j, i * 0, j * 0, pix, cam, key, depth)

    S = 4
    for W in (64, 512):  # 512x512: the main path's chunk, 2^18 pixels
        args = pixel_args(W)
        kout = pk.pt_megakernel_pixels(*args, spp_loop=S * S, sqrt_spp=S)
        pout = pk.pt_megakernel_pixels_plain(*args, spp_loop=S * S, sqrt_spp=S)
        torch.cuda.synchronize()
        frac, max_err = compare(
            f"phase 2: pt_megakernel_pixels {W}x{W} spp={S * S} depth={depth}",
            kout, pout, exact_counts=True)
        del kout, pout
    ms = time_ms(lambda: pk.pt_megakernel_pixels(*args, spp_loop=S * S,
                                                 sqrt_spp=S), reps=5)
    plain_ms = time_ms(lambda: pk.pt_megakernel_pixels_plain(
        *args, spp_loop=S * S, sqrt_spp=S), reps=2)
    print(f"phase 2: pt_megakernel_pixels at {W}x{W} x {S * S} spp, depth "
          f"{depth}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})")

    # ---- phase 3: the main path
    cfg = dataclasses.replace(cornell_box_camera(), image_width=512,
                              samples_per_pixel=16, max_depth=10,
                              integrator="pt")
    render(scene, cfg, seed=0)  # warm-up
    pk.pt_megakernel.launches = pk.pt_megakernel_pixels.launches = 0
    pk.pt_megakernel_plain.calls = pk.pt_megakernel_pixels_plain.calls = 0
    results = [render(scene, cfg, seed=0) for _ in range(3)]
    launches = pk.pt_megakernel.launches + pk.pt_megakernel_pixels.launches
    plain_calls = pk.pt_megakernel_plain.calls + pk.pt_megakernel_pixels_plain.calls
    check(pk.pt_megakernel_pixels.launches > 0, "main path launched no kernel")
    check(plain_calls == 0, f"main path called the plain version {plain_calls} times")
    walls = [r.stats.wall_seconds for r in results]
    wall = statistics.median(walls)
    res = results[0]
    rays = res.stats.rays_traced
    fb = res.framebuffer_sum
    check(fb.shape == (512, 512, 3), f"framebuffer shape {fb.shape}")
    check(bool(np.isfinite(fb).all()), "non-finite framebuffer")
    check(float(fb.mean()) > 0.0, "black image")
    check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
          "renders with the same seed differ")
    check(abs(rays - EXPECTED_RAYS) <= 1e-4 * EXPECTED_RAYS,
          f"rays_traced {rays} is not within 0.01% of {EXPECTED_RAYS}")
    path = write_png("chip_smoke_cornell_pt.png", res.rgb8(), output_dir="output")
    print(f"phase 3: render 512x512 16 spp depth 10 seed 0: walls "
          f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
          f"{rays / wall / 1e6:.3f} Mrays/s; rays_traced {rays} "
          f"(expected {EXPECTED_RAYS}, "
          f"{(rays - EXPECTED_RAYS) / EXPECTED_RAYS * 100:+.4f}%; TPU bench "
          f"{TPU_BENCH_RAYS}, {(rays - TPU_BENCH_RAYS) / TPU_BENCH_RAYS * 100:+.4f}%)"
          f"; tri tests {res.stats.triangle_tests}, "
          f"tri hits {res.stats.triangle_hits}; kernel launches {launches}, "
          f"plain calls {plain_calls}; wrote {path} ({card})")

    print(json.dumps({"kernels": [{
        "name": "pt_megakernel",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/pt_megakernel.cu",
        "replaces": "bpt_tpu/ops/pallas/pt_kernel.py:1334",
        "launches": launches,
        "max_abs_err": max_err,
        "within_tol": frac,
        "ms": ms,
        "plain_ms": plain_ms,
        "rays_mode_ms": rays_ms,
        "rays_mode_plain_ms": rays_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
