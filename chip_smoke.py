#!/usr/bin/env python3
"""Smoke test of bpt_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernel from bpt_tpu_torch/csrc/ (printing the build seconds and ptxas's
   register report).
2. Holds each kernel against its plain PyTorch version on the card, on the
   same inputs.  PT: pt_megakernel with injected uniforms and in RNG mode
   at B = 65,536 rays, depth 10; pt_megakernel_pixels at 64x64 and at the
   main path's chunk shape, 512x512 (2^18 pixels), both 16 spp, depth 10;
   tolerance rtol 1e-4 / atol 1e-6.  BDPT, for bdpt and bdpt-mis:
   bdpt_megakernel with injected uniforms and in RNG mode at B = 65,536,
   depth 10 on the cornell box and B = 16,384 on the mixed-material
   scene; bdpt_megakernel_pixels at the main path's shape (512x512, 16
   spp, depth 10), and bdpt-mis at 64x64, 4 spp, depth 80 on the mixed
   scene; tolerance rtol 1e-4 / atol 1e-5.  Each comparison needs >= 99.9%
   of lanes within tolerance (a path may take another branch on a one-ulp
   difference; the worst lane is printed), and the pixels mode's counters
   must be exact.  Times kernel and plain version at B = 65,536 and at
   512x512, and the kernel at depth 80.
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
   Then the same for BDPT and BDPT-MIS (the CLI's default integrator and
   its MIS variant): each kernel launched, the plain version never, the
   image deterministic, finite and not black; rays_traced and shadow_rays
   are printed beside the TPU bench's counts (BENCH_r04.json) and those of
   bpt_tpu's fused kernel on a CPU, not checked.  Writes output/chip_smoke_cornell_bdpt{,-mis}.png.

4. The coffee stand-in (91,540 triangles), built from the five OBJ files
   and three light meshes of scenes/coffee/coffee_standin.yaml through
   SceneBuilder calls; where PyYAML is installed, also loaded through the
   port's loader and held equal.  Prints the parse, BVH and upload seconds.
5. closest_bvh against its plain version (ops.soa.bvh_closest) at B =
   65,536, on the coffee camera's primary rays and on as many random rays
   inside the scene's bounds: hit, triangle and t exact on >= 99.9% of
   lanes, the four counters exact.  Times kernel and plain version.
6. pt_wave against pt_wave_plain at B = 65,536 coffee rays, depth 10, in
   both modes (the wave kernel walks the BVH; paged=True: closest_bvh, then
   the shade-only wave kernel), rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes,
   rays_traced and the four walk counters exact.
7. The main path: render() of the coffee stand-in with PT at 512x512, 16
   spp, depth 10, seed 0 (bench.py's coffee cell) — one warm-up and three
   timed renders.  The wave kernel's launches must be > 0 and every plain
   version's calls 0, the image finite, not black and bitwise identical
   across renders.  rays_traced is printed beside the TPU bench's
   11,110,273 (BENCH_r03/r04.json), not checked against it: bpt_tpu's own
   Pallas pt_wave counts 2.58% fewer rays than its BVH path on a pixel
   subset (tools/coffee_reference_rays.py; PERF.md, Findings).  Checked
   instead: the port's count on that subset (every 257th pixel, all 16
   strata) within 0.1% of bpt_tpu's BVH path on a CPU (44,024), and the
   whole image within 1% of the TPU count scaled by bpt_tpu's own BVH /
   Pallas ratio on the subset.  Writes output/chip_smoke_coffee_pt.png.
   Then closest_bvh's path: the same render loop with paging forced
   (render() does not page this scene), its launches counted there, no
   plain version called, the image bitwise equal to render()'s and every
   counter equal.  Last, one wave-kernel launch against its plain version
   at the main path's first bounce (B = 4,194,304): all 13 state rows
   (origin, direction and throughput on the lanes that stay alive) within
   rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes, all five counters exact;
   both timed.

Each phase prints its seconds.  The second-to-last line is a JSON object
describing the kernels, each with its bound: the larger of the bytes it
must move over 3.35 TB/s and its FP32 operations (from its counters) over
67 TFLOP/s; the last line is {"ok": true, "device": {...}}.  Any failure
exits non-zero, and so does a machine without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

RTOL, ATOL, BDPT_ATOL, MIN_FRAC = 1e-4, 1e-6, 1e-5, 0.999
# the H100 SXM's published peaks: HBM bytes/s
# and FP32 operations/s outside the tensor cores
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# FP32 operations of one Möller–Trumbore test (common.cuh: 2 crosses, 4
# dots, a reciprocal, 3 subtractions, 7 acceptance compares) and of one
# node's slab test (pt_wave.cu: 12 for the three axes' t0/t1, 6 min/max,
# 6 for entry and exit, 1 compare); the kernels' counters say how many ran
MT_OPS, SLAB_OPS = 52, 25
COFFEE_YAML = "scenes/coffee/coffee_standin.yaml"
TPU_BENCH_COFFEE_RAYS = 11_110_273  # BENCH_r03/r04.json; printed, not checked
# tools/coffee_reference_rays.py on a CPU, every 257th pixel x 16 strata:
# bpt_tpu's BVH path and its Pallas pt_wave
CPU_BVH_COFFEE_SUBSET, CPU_PALLAS_COFFEE_SUBSET = 44_024, 42_887
EXPECTED_RAYS = 11_506_161  # bpt_tpu fused kernel, interpret mode on a CPU
TPU_BENCH_RAYS = 11_497_620  # BENCH_r02..r04.json; printed, not checked
# cornell 512x512 / 16 spp / d10 / seed 0: rays, shadow rays.  The TPU
# runs of BENCH_r04.json, and bpt_tpu's fused kernel in interpret mode on a
# CPU (tools/pt_reference_rays.py --integrator ...); printed, not checked
TPU_BENCH_BDPT = {"bdpt": (40_468_228, 57_164_656),
                  "bdpt-mis": (40_468_228, 49_503_600)}
CPU_REF_BDPT = {"bdpt": (40_532_450, 56_644_333),
                "bdpt-mis": (40_532_450, 49_893_268)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def agreement(got, want, atol=ATOL):
    """(fraction of lanes within tolerance on all channels, max abs err,
    index of the lane whose error uses the most of its tolerance) of [B,3]
    kernel vs plain radiance."""
    err = (got - want).abs()
    used = (err / (atol + RTOL * want.abs())).max(dim=1).values
    ok = used <= 1.0
    worst = int(used.argmax())
    return float(ok.double().mean()), float(err.max()), worst


def counters(out):
    """[rays, nodes, aabb, tri tests, tri hits] of a PT kernel's outputs,
    [rays, shadow, nodes, aabb, tri tests, tri hits] of a BDPT kernel's."""
    return [int(x) for x in out[3:-1]] + [int(x) for x in out[-1]]


def compare(name, kernel_out, plain_out, exact_counts: bool, atol=ATOL):
    import torch

    got = torch.stack(kernel_out[:3], dim=1)
    want = torch.stack(plain_out[:3], dim=1)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel radiance")
    frac, max_err, worst = agreement(got, want, atol)
    kc, pc = counters(kernel_out), counters(plain_out)
    names = "rays, nodes, aabb" if len(kc) == 5 else "rays, shadow, nodes, aabb"
    print(f"{name}: {frac * 100:.4f}% of {got.shape[0]} lanes within rtol "
          f"{RTOL} / atol {atol}; max abs err {max_err:.3e}; worst lane "
          f"{worst}: kernel {got[worst].tolist()} plain {want[worst].tolist()}; "
          f"counters ({names}, tri tests, tri hits) kernel {kc} plain {pc}")
    check(frac >= MIN_FRAC, f"{name}: only {frac:.5f} of lanes agree")
    if exact_counts:
        check(kc == pc, f"{name}: counters differ: kernel {kc} plain {pc}")
    return frac, max_err


def _gap(n: int, tpu: int, cpu: int) -> str:
    return (f"TPU bench {tpu}, {(n - tpu) / tpu * 100:+.4f}%; bpt_tpu on a CPU "
            f"{cpu}, {(n - cpu) / cpu * 100:+.4f}%")


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


def timed(fn):
    """(fn(), ms) of one call between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    b, o = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def coffee_builder():
    """scenes/coffee/coffee_standin.yaml through SceneBuilder calls: its
    materials (the loader's 0-255 autoscale), its five OBJ meshes and its
    three light quads, in the file's order."""
    from bpt_tpu_torch.scene.builder import MaterialSpec as MS, SceneBuilder
    from bpt_tpu_torch.scene.loader import read_color_scaled

    def rgb(c):
        return read_color_scaled(c, (0.0, 0.0, 0.0))

    b = SceneBuilder()
    for name, mat in (("Plastic_Orange", MS.lambertian(rgb([255, 97, 3]))),
                      ("Plastic_Black", MS.lambertian(rgb([0, 0, 0]))),
                      ("Metal", MS.metal(rgb([170, 170, 170]), 0.1)),
                      ("Glass", MS.dielectric(1.5)),
                      ("Floor", MS.lambertian(rgb([147, 147, 147])))):
        b.add_obj(f"scenes/coffee/data/{name}.obj", mat)
    light = MS.diffuse_light((245.0, 245.0, 245.0))
    for q in ([(-0.359309, 0.449693, -0.010809), (-0.196537, 0.449693, 0.338256),
               (-0.196537, 0.000849009, 0.338256), (-0.359309, 0.000848979, -0.010809)],
              [(0.320673, 0.027337, 0.228975), (0.320673, 0.476182, 0.228975),
               (0.325221, 0.476182, -0.136419), (0.325221, 0.027337, -0.136419)],
              [(0.230128, 0.50385, 0.267372), (-0.230128, 0.50385, 0.267372),
               (-0.230128, 0.50385, -0.192885), (0.230128, 0.50385, -0.192885)]):
        b.add_triangle(q[0], q[1], q[2], light)
        b.add_triangle(q[0], q[2], q[3], light)
    return b


def coffee_camera():
    """The YAML's camera at bench.py's coffee cell: 512x512, 16 spp,
    depth 10, PT."""
    from bpt_tpu_torch.scene.types import CameraConfig

    return CameraConfig(aspect_ratio=1.0, image_width=512, samples_per_pixel=16,
                        max_depth=10, vfov=30.0, lookfrom=(-0.02, 0.22, 0.85),
                        lookat=(0.0, 0.16, 0.02), file_name="coffee_standin.png",
                        integrator="pt")


def wave_rays(cc, pix, strata, key, dev):
    """The pt_wave render loop's primary rays for pixels ``pix`` and
    strata 0..strata-1 (models/render.py::_render_wave): (o, d, ray ids)."""
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models.camera import generate_rays

    S, W = cc.sqrt_spp, cc.width
    pixb = pix.repeat(strata)
    s = torch.arange(strata, device=dev).repeat_interleave(pix.numel())
    ids = pixb * (S * S) + s
    u0, u1 = rng.raygen_jitter(key, ids)
    z = torch.zeros_like(u0)
    o3, d3 = generate_rays(cc, (pixb % W).float(), (pixb // W).float(), (s % S).float(),
                           (s // S).float(), torch.stack([u0, u1, z, z], -1))
    return Vec3(*o3.unbind(1)), Vec3(*d3.unbind(1)), ids.to(torch.int32)


class Laps:
    """Prints the seconds since the previous lap."""

    def __init__(self):
        self.t = time.monotonic()

    def __call__(self, name):
        now = time.monotonic()
        print(f"{name} took {now - self.t:.1f} s")
        self.t = now


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
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene import builder
    from bpt_tpu_torch.scene.presets import (
        cornell_box,
        cornell_box_builder,
        cornell_box_camera,
    )
    from bpt_tpu_torch.utils.png import write_png

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    lap = Laps()
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
    lap("phase 1")

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
    pt_rays_tests = counters(kout)[3]  # RNG mode, the timed call below
    rays_ms = time_ms(lambda: pk.pt_megakernel(scene, ov, dv, ids, key, depth),
                      reps=10)
    rays_plain_ms = time_ms(lambda: pk.pt_megakernel_plain(
        scene, ov, dv, ids, key, depth), reps=3)
    print(f"phase 2: pt_megakernel rng mode B={B} depth={depth}: kernel "
          f"{rays_ms:.3f} ms, plain {rays_plain_ms:.3f} ms ({card})")

    def pixel_args(width, S=4):
        """(i, j, pixel ids, camera table) of a one-chunk render of a
        width x width image, built as models/render.py builds them."""
        cfg = dataclasses.replace(cornell_box_camera(), image_width=width,
                                  samples_per_pixel=S * S)
        cam = pk.camera_table(camera_constants(cfg, torch.float32, dev))
        pix = torch.arange(width * width, dtype=torch.int64, device=dev)
        return (pix % width).float(), (pix // width).float(), pix, cam

    S = 4
    for W in (64, 512):  # 512x512: the main path's chunk, 2^18 pixels
        i, j, pix, cam = pixel_args(W)
        args = (scene, i, j, i * 0, j * 0, pix, cam, key, depth)
        kout = pk.pt_megakernel_pixels(*args, spp_loop=S * S, sqrt_spp=S)
        pout = pk.pt_megakernel_pixels_plain(*args, spp_loop=S * S, sqrt_spp=S)
        torch.cuda.synchronize()
        frac, max_err = compare(
            f"phase 2: pt_megakernel_pixels {W}x{W} spp={S * S} depth={depth}",
            kout, pout, exact_counts=True)
        pt_tests = counters(kout)[3]
        del kout, pout
    ms = time_ms(lambda: pk.pt_megakernel_pixels(*args, spp_loop=S * S,
                                                 sqrt_spp=S), reps=5)
    plain_ms = time_ms(lambda: pk.pt_megakernel_pixels_plain(
        *args, spp_loop=S * S, sqrt_spp=S), reps=2)
    print(f"phase 2: pt_megakernel_pixels at {W}x{W} x {S * S} spp, depth "
          f"{depth}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})")
    lap("phase 2 (PT)")

    # ---- phase 2, BDPT: bdpt_megakernel vs its plain version
    # the mixed-material scene of tests/torch_parity.py::mixed_scene
    MS = builder.MaterialSpec
    mb = cornell_box_builder()
    mb.add_quad((60, 20, 60), (150, 0, 0), (0, 150, 40), MS.metal((0.8, 0.85, 0.9), 0.3))
    mb.add_box((340, 0, 80), (460, 120, 200), MS.dielectric(1.5))
    mb.add_quad((100, 400, 400), (120, 0, 0), (0, 0, 100), MS.isotropic((0.6, 0.7, 0.5)))
    mixed = mb.build(device=dev)
    n_slots = bk.n_uniform_slots(depth)
    bdpt_err, bdpt_frac = 0.0, 1.0
    for sc_name, sc, nb in (("cornell", scene, B), ("mixed", mixed, 16384)):
        ovb, dvb = Vec3(*(x[:nb] for x in ov)), Vec3(*(x[:nb] for x in dv))
        ub = torch.from_numpy(g.uniform(size=(n_slots, nb)).astype(np.float32)).to(dev)
        for mis in (False, True):
            for mode, u in (("buffer", ub), ("rng", None)):
                a = (sc, ovb, dvb, ids[:nb], key, depth)
                kout = bk.bdpt_megakernel(*a, uniforms=u, mis=mis)
                pout = bk.bdpt_megakernel_plain(*a, uniforms=u, mis=mis)
                torch.cuda.synchronize()
                f, e = compare(f"phase 2: bdpt_megakernel {'bdpt-mis' if mis else 'bdpt'} "
                               f"{mode} mode {sc_name} B={nb} depth={depth}",
                               kout, pout, exact_counts=False, atol=BDPT_ATOL)
                bdpt_err, bdpt_frac = max(bdpt_err, e), min(bdpt_frac, f)
                if (sc_name, mis, mode) == ("cornell", False, "rng"):
                    bdpt_rays_tests = counters(kout)[4]  # the timed call below
    a = (scene, ov, dv, ids, key, depth)
    bdpt_rays_ms = time_ms(lambda: bk.bdpt_megakernel(*a), reps=5)
    bdpt_rays_plain_ms = time_ms(lambda: bk.bdpt_megakernel_plain(*a), reps=2)
    print(f"phase 2: bdpt_megakernel rng mode B={B} depth={depth}: kernel "
          f"{bdpt_rays_ms:.3f} ms, plain {bdpt_rays_plain_ms:.3f} ms ({card})")

    S = 4
    i, j, pix, cam = pixel_args(512)
    bdpt_ms, bdpt_plain_ms = {}, {}
    for name in ("bdpt", "bdpt-mis"):
        a = (scene, i, j, pix, cam, key, depth, S)
        mis = name == "bdpt-mis"
        kout = bk.bdpt_megakernel_pixels(*a, mis=mis)
        torch.cuda.reset_peak_memory_stats(dev)
        pout, bdpt_plain_ms[name] = timed(
            lambda: bk.bdpt_megakernel_pixels_plain(*a, mis=mis))
        plain_peak = torch.cuda.max_memory_allocated(dev)
        f, e = compare(f"phase 2: bdpt_megakernel_pixels {name} 512x512 spp={S * S} "
                       f"depth={depth}", kout, pout, exact_counts=True, atol=BDPT_ATOL)
        bdpt_err, bdpt_frac = max(bdpt_err, e), min(bdpt_frac, f)
        if name == "bdpt":
            bdpt_tests = counters(kout)[4]
        del kout, pout
        bdpt_ms[name] = time_ms(lambda: bk.bdpt_megakernel_pixels(*a, mis=mis), reps=5)
        print(f"phase 2: bdpt_megakernel_pixels {name} at 512x512 x {S * S} spp, "
              f"depth {depth}: kernel {bdpt_ms[name]:.3f} ms, plain "
              f"{bdpt_plain_ms[name]:.3f} ms (one call, peak device memory "
              f"{plain_peak / 2**30:.2f} GiB) ({card})")
    i, j, pix, cam = pixel_args(64, 2)
    a = (mixed, i, j, pix, cam, key, 80, 2)
    kout = bk.bdpt_megakernel_pixels(*a, mis=True)
    pout = bk.bdpt_megakernel_pixels_plain(*a, mis=True)
    f, e = compare("phase 2: bdpt_megakernel_pixels bdpt-mis mixed 64x64 spp=4 depth=80",
                   kout, pout, exact_counts=True, atol=BDPT_ATOL)
    bdpt_err, bdpt_frac = max(bdpt_err, e), min(bdpt_frac, f)
    del kout, pout
    d80_ms = time_ms(lambda: bk.bdpt_megakernel_pixels(*a, mis=True), reps=5)
    print(f"phase 2: bdpt_megakernel_pixels bdpt-mis mixed 64x64 x 4 spp, depth 80: "
          f"kernel {d80_ms:.3f} ms ({card})")
    lap("phase 2 (BDPT)")

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
    lap("phase 3 (PT)")

    # ---- phase 3, BDPT and BDPT-MIS main paths (the CLI's default)
    bdpt_launches = 0
    for name in ("bdpt", "bdpt-mis"):
        cfg = dataclasses.replace(cfg, integrator=name)
        render(scene, cfg, seed=0)  # warm-up
        bk.bdpt_megakernel.launches = bk.bdpt_megakernel_pixels.launches = 0
        bk.bdpt_megakernel_plain.calls = bk.bdpt_megakernel_pixels_plain.calls = 0
        results = [render(scene, cfg, seed=0) for _ in range(3)]
        n_launch = bk.bdpt_megakernel.launches + bk.bdpt_megakernel_pixels.launches
        n_plain = bk.bdpt_megakernel_plain.calls + bk.bdpt_megakernel_pixels_plain.calls
        check(bk.bdpt_megakernel_pixels.launches > 0, f"{name} main path launched no kernel")
        check(n_plain == 0, f"{name} main path called the plain version {n_plain} times")
        bdpt_launches += n_launch
        walls = [r.stats.wall_seconds for r in results]
        wall = statistics.median(walls)
        res = results[0]
        fb = res.framebuffer_sum
        check(fb.shape == (512, 512, 3), f"{name} framebuffer shape {fb.shape}")
        check(bool(np.isfinite(fb).all()), f"{name}: non-finite framebuffer")
        check(float(fb.mean()) > 0.0, f"{name}: black image")
        check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
              f"{name}: renders with the same seed differ")
        st = res.stats
        check(st.rays_traced > 0 and st.shadow_rays > 0, f"{name}: no rays counted")
        tpu_rays, tpu_shadow = TPU_BENCH_BDPT[name]
        cpu_rays, cpu_shadow = CPU_REF_BDPT[name]
        path = write_png(f"chip_smoke_cornell_{name}.png", res.rgb8(), output_dir="output")
        print(f"phase 3: render {name} 512x512 16 spp depth 10 seed 0: walls "
              f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
              f"{st.rays_traced / wall / 1e6:.3f} Mrays/s on rays_traced "
              f"({st.total_rays / wall / 1e6:.3f} with shadow rays); rays_traced "
              f"{st.rays_traced} ({_gap(st.rays_traced, tpu_rays, cpu_rays)}), "
              f"shadow_rays {st.shadow_rays} "
              f"({_gap(st.shadow_rays, tpu_shadow, cpu_shadow)}); tri tests "
              f"{st.triangle_tests}, tri hits {st.triangle_hits}; kernel launches "
              f"{n_launch}, plain calls {n_plain}; wrote {path} ({card})")
        lap(f"phase 3 ({name})")

    # ---- phase 4: the coffee stand-in, from its OBJ files
    from bpt_tpu_torch.ops.kernels import pt_wave as pw
    from bpt_tpu_torch.scene.types import scene_from_numpy, scene_to_numpy

    t0 = time.monotonic()
    cb = coffee_builder()
    t_parse = time.monotonic() - t0
    host = cb.build(device="cpu")
    t_bvh = time.monotonic() - t0 - t_parse
    coffee = scene_from_numpy(*scene_to_numpy(host), device=dev)
    torch.cuda.synchronize()
    t_up = time.monotonic() - t0 - t_parse - t_bvh
    arrays, meta = scene_to_numpy(coffee)
    try:
        import yaml  # noqa: F401
    except ImportError:
        how = "SceneBuilder calls only (PyYAML is not installed here)"
    else:
        from bpt_tpu_torch.scene.loader import load_scene_from_yaml

        loaded = load_scene_from_yaml(COFFEE_YAML, device=dev, verbose=False).scene
        la, lm = scene_to_numpy(loaded)
        check(lm == meta and all(np.array_equal(la[k], arrays[k]) for k in arrays),
              "the loader's coffee scene differs from the builder's")
        how = "SceneBuilder calls, and the YAML loader gives the same scene"
        del loaded
    check(coffee.num_tris == 91_540 and coffee.use_bvh, f"coffee: {coffee.num_tris} tris")
    paged_main = not pw.cluster_ok(coffee)
    print(f"phase 4: coffee stand-in, {coffee.num_tris} triangles, "
          f"{int(coffee.bvh_skip.shape[0])} BVH nodes, {coffee.num_lights} light "
          f"triangles via {how}; parse {t_parse:.3f} s, BVH and tables {t_bvh:.3f} s, "
          f"upload {t_up:.3f} s; cluster_ok {not paged_main} (the render "
          f"{'pages' if paged_main else 'does not page'})")
    lap("phase 4")

    # ---- phase 5: closest_bvh vs bvh_closest
    ccc = camera_constants(coffee_camera(), torch.float32, dev)
    B = 65536
    o_p, d_p, ids_p = wave_rays(ccc, torch.arange(B, device=dev) * 4, 1, key, dev)
    lo, hi = (x.cpu().numpy() for x in (coffee.bvh_min[0], coffee.bvh_max[0]))
    o_r = Vec3(*torch.from_numpy(g.uniform(lo, hi, (B, 3)).astype(np.float32)).to(dev).unbind(1))
    d_r = Vec3(*torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev).unbind(1))
    act = torch.ones(B, dtype=torch.bool, device=dev)
    a_frac, a_err = 1.0, 0.0
    for name, o_, d_ in (("primary", o_p, d_p), ("random", o_r, d_r)):
        kout = pw.closest_bvh(coffee, o_, d_, act)
        pout, a_plain_ms = timed(lambda: pw.closest_bvh_plain(coffee, o_, d_, act))
        same = (kout[1] == pout[1]) & ((kout[0] == pout[0]) | (kout[0].isinf() & pout[0].isinf()))
        frac = float(same.double().mean())
        kc, pc = kout[4].tolist(), pout[4].tolist()
        print(f"phase 5: closest_bvh {name} rays B={B}: hit, tri and t equal on "
              f"{frac * 100:.4f}% of lanes ({int((kout[1] >= 0).sum())} hits); counters "
              f"(node visits, box hits, tri tests, tri hits) kernel {kc} plain {pc}; "
              f"plain {a_plain_ms:.3f} ms")
        check(frac >= MIN_FRAC, f"closest_bvh {name}: only {frac:.5f} of lanes agree")
        check(kc == pc, f"closest_bvh {name}: counters differ")
        both = kout[0].isfinite() & pout[0].isfinite()
        a_frac = min(a_frac, frac)
        a_err = max(a_err, float((kout[0] - pout[0])[both].abs().max()))
        if name == "primary":
            a_counts, a_plain_primary_ms = kc, a_plain_ms
    a_ms = time_ms(lambda: pw.closest_bvh(coffee, o_p, d_p, act), reps=10)
    tables = pw.pack_bvh(coffee)
    scene_bytes = sum(t.numel() * t.element_size() for t in tables)
    a_bound, a_by = bound(B * (6 * 4 + 1 + 4 * 4) + scene_bytes,
                          a_counts[0] * SLAB_OPS + a_counts[2] * MT_OPS)
    print(f"phase 5: closest_bvh primary rays B={B}: kernel {a_ms:.3f} ms, plain "
          f"{a_plain_primary_ms:.3f} ms, bound {a_bound:.4f} ms ({a_by}) ({card})")
    lap("phase 5")

    # ---- phase 6: pt_wave vs pt_wave_plain, both modes
    key_pt = rng.fold_in(key, 1)
    wave_args = (coffee, o_p, d_p, ids_p, key_pt, depth)
    wplain, wave_plain_ms = timed(lambda: pw.pt_wave_plain(*wave_args))
    wave_err, wave_frac, wave_ms = 0.0, 1.0, {}
    for paged in (False, True):
        pw.closest_bvh.launches = pw.pt_wave_bounce.launches = 0
        pw.closest_bvh_plain.calls = pw.pt_wave_bounce_plain.calls = 0
        kout = pw.pt_wave(*wave_args, paged=paged)
        torch.cuda.synchronize()
        a_launches, b_launches = pw.closest_bvh.launches, pw.pt_wave_bounce.launches
        n_plain = pw.closest_bvh_plain.calls + pw.pt_wave_bounce_plain.calls
        mode = "paged (closest_bvh + shade-only wave kernel)" if paged else "walk"
        f, e = compare(f"phase 6: pt_wave {mode} B={B} depth={depth}", kout, wplain,
                       exact_counts=True)
        check(b_launches == depth and a_launches == (depth if paged else 0) and not n_plain,
              f"pt_wave {mode}: launches {a_launches} / {b_launches}, plain calls {n_plain}")
        wave_err, wave_frac = max(wave_err, e), min(wave_frac, f)
        wave_ms[paged] = time_ms(lambda: pw.pt_wave(*wave_args, paged=paged), reps=5)
    print(f"phase 6: pt_wave B={B} depth={depth}: walk {wave_ms[False]:.3f} ms, paged "
          f"{wave_ms[True]:.3f} ms, plain {wave_plain_ms:.3f} ms (one call) ({card})")
    del wplain, kout
    lap("phase 6")

    # ---- phase 7: the main path, the coffee render through pt_wave
    cfg = coffee_camera()
    render(coffee, cfg, seed=0)  # warm-up
    plains = (pk.pt_megakernel_plain, pk.pt_megakernel_pixels_plain,
              bk.bdpt_megakernel_plain, bk.bdpt_megakernel_pixels_plain,
              pw.closest_bvh_plain, pw.pt_wave_bounce_plain, pw.pt_wave_plain)
    for fn in plains:
        fn.calls = 0
    pw.closest_bvh.launches = pw.pt_wave_bounce.launches = 0
    results = [render(coffee, cfg, seed=0) for _ in range(3)]
    wave_launches = pw.pt_wave_bounce.launches
    n_plain = sum(fn.calls for fn in plains)
    check(wave_launches > 0, "coffee main path launched no wave kernel")
    check(n_plain == 0, f"coffee main path called a plain version {n_plain} times")
    check(pw.closest_bvh.launches == (wave_launches if paged_main else 0),
          f"coffee main path launched closest_bvh {pw.closest_bvh.launches} times")
    walls = [r.stats.wall_seconds for r in results]
    wall = statistics.median(walls)
    res = results[0]
    st = res.stats
    fb = res.framebuffer_sum
    check(fb.shape == (512, 512, 3), f"coffee framebuffer shape {fb.shape}")
    check(bool(np.isfinite(fb).all()), "coffee: non-finite framebuffer")
    check(float(fb.mean()) > 0.0, "coffee: black image")
    check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
          "coffee: renders with the same seed differ")
    # the subset of tools/coffee_reference_rays.py, through the kernels
    sub = wave_rays(ccc, torch.arange(0, 512 * 512, 257, device=dev), 16, key, dev)
    sub_rays = int(pw.pt_wave(coffee, *sub, key_pt, depth)[3])
    check(abs(sub_rays - CPU_BVH_COFFEE_SUBSET) <= 1e-3 * CPU_BVH_COFFEE_SUBSET,
          f"coffee subset rays {sub_rays} not within 0.1% of {CPU_BVH_COFFEE_SUBSET}")
    scaled = TPU_BENCH_COFFEE_RAYS * CPU_BVH_COFFEE_SUBSET / CPU_PALLAS_COFFEE_SUBSET
    check(abs(st.rays_traced - scaled) <= 1e-2 * scaled,
          f"coffee rays_traced {st.rays_traced} not within 1% of {scaled:.0f}")
    path = write_png("chip_smoke_coffee_pt.png", res.rgb8(), output_dir="output")
    tpu_gap = (st.rays_traced - TPU_BENCH_COFFEE_RAYS) / TPU_BENCH_COFFEE_RAYS * 100
    print(f"phase 7: render coffee 512x512 16 spp depth 10 seed 0: walls "
          f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
          f"{st.rays_traced / wall / 1e6:.3f} Mrays/s; rays_traced {st.rays_traced} "
          f"(TPU bench {TPU_BENCH_COFFEE_RAYS}, {tpu_gap:+.4f}%; that count scaled by "
          f"bpt_tpu's BVH / Pallas ratio {scaled:.0f}, "
          f"{(st.rays_traced - scaled) / scaled * 100:+.4f}%); every 257th pixel: "
          f"{sub_rays} rays (bpt_tpu's BVH path on a CPU {CPU_BVH_COFFEE_SUBSET}, "
          f"{(sub_rays - CPU_BVH_COFFEE_SUBSET) / CPU_BVH_COFFEE_SUBSET * 100:+.4f}%; "
          f"its Pallas pt_wave {CPU_PALLAS_COFFEE_SUBSET}); node visits "
          f"{st.bvh_node_visits}, box hits {st.aabb_hits}, tri tests {st.triangle_tests}, "
          f"tri hits {st.triangle_hits}; wave kernel launches {wave_launches}, plain "
          f"calls {n_plain}; wrote {path} ({card})")

    # closest_bvh's path: the same render loop with paging forced (the
    # coffee scene passes cluster_ok, so render() itself does not page)
    from bpt_tpu_torch.models.render import _render_wave

    cc_r = camera_constants(cfg, torch.float32, dev)
    for fn in plains:
        fn.calls = 0
    pw.closest_bvh.launches = pw.pt_wave_bounce.launches = 0
    fb_paged = torch.zeros((512 * 512, 3), device=dev)
    (p_rays, p_extra), paged_render_ms = timed(
        lambda: _render_wave(coffee, cfg, cc_r, 0, fb_paged, 0, None, None, paged=True))
    paged_launches = pw.closest_bvh.launches
    n_plain = sum(fn.calls for fn in plains)
    check(paged_launches > 0 and paged_launches == pw.pt_wave_bounce.launches,
          f"paged render: closest_bvh {paged_launches} launches, wave kernel "
          f"{pw.pt_wave_bounce.launches}")
    check(n_plain == 0, f"paged render called a plain version {n_plain} times")
    p_counts = [int(p_rays), *p_extra.tolist()]
    w_counts = [st.rays_traced, st.bvh_node_visits, st.aabb_hits, st.triangle_tests,
                st.triangle_hits]
    check(p_counts == w_counts, f"paged render counters {p_counts}, unpaged {w_counts}")
    check(np.array_equal(fb_paged.cpu().numpy().reshape(512, 512, 3), fb),
          "paged render's image differs from render()'s")
    print(f"phase 7: the same render paged (closest_bvh, then the shade-only wave "
          f"kernel): {paged_render_ms:.3f} ms; image bitwise equal to render()'s and "
          f"counters (rays, node visits, box hits, tri tests, tri hits) {p_counts} "
          f"equal; closest_bvh launches {paged_launches}, plain calls {n_plain} ({card})")
    del results, res, fb, fb_paged

    # the wave kernel at the main path's first bounce: 16 strata of 512^2
    o_m, d_m, ids_m = wave_rays(ccc, torch.arange(512 * 512, device=dev), 16, key, dev)
    Bm = int(ids_m.shape[0])
    state = torch.empty((pw.STATE_ROWS, Bm), device=dev)
    state[pw.OX:pw.DX + 3] = torch.stack([*o_m, *d_m])
    state[pw.THR:pw.THR + 3] = 1.0
    state[pw.RAD:pw.RAD + 3] = 0.0
    state[pw.ALIVE] = 1.0
    del o_m, d_m
    b_out, b_counts = pw.pt_wave_bounce(coffee, state, ids_m, key_pt, 0, tables=tables)
    b_ms = time_ms(lambda: pw.pt_wave_bounce(coffee, state, ids_m, key_pt, 0,
                                             tables=tables), reps=5)
    (p_out, p_counts), b_plain_ms = timed(
        lambda: pw.pt_wave_bounce_plain(coffee, state, ids_m, key_pt, 0))
    # every state row; a dead lane's origin, direction and throughput are
    # never read again, so those rows count on the lanes the plain version
    # keeps alive (a lane alive on one side only fails on the alive row)
    live = p_out[pw.ALIVE] > 0.5
    rows, prows = (torch.cat([torch.where(live, x[:pw.RAD], 0.0), x[pw.RAD:]]).T
                   for x in (b_out, p_out))
    f, e, worst = agreement(rows, prows)
    b_counts, p_counts = b_counts.tolist(), p_counts.tolist()
    check(bool(live.any()), "wave kernel at bounce 0: no lane stays alive")
    check(f >= MIN_FRAC, f"wave kernel at bounce 0: only {f:.5f} of lanes agree; worst "
          f"lane {worst}: kernel {rows[worst].tolist()} plain {prows[worst].tolist()}")
    check(b_counts == p_counts, f"wave kernel at bounce 0: counters {b_counts} vs {p_counts}")
    wave_err, wave_frac = max(wave_err, e), min(wave_frac, f)
    b_bound, b_by = bound(Bm * (2 * pw.STATE_ROWS * 4 + 4) + scene_bytes,
                          b_counts[1] * SLAB_OPS + b_counts[3] * MT_OPS)
    print(f"phase 7: wave kernel, first bounce of the main path (B={Bm}): kernel "
          f"{b_ms:.3f} ms, plain {b_plain_ms:.3f} ms (one call), bound {b_bound:.4f} ms "
          f"({b_by}); all {pw.STATE_ROWS} state rows within rtol {RTOL} / atol {ATOL} "
          f"on {f * 100:.4f}% of lanes ({int(live.sum())} alive), max abs err {e:.3e}; counters "
          f"(rays, node visits, box hits, tri tests, tri hits) kernel {b_counts} plain "
          f"{p_counts} ({card})")
    del state, b_out, p_out, rows, prows
    lap("phase 7")

    # lanes in (pixels: i, j, sx, sy, id; rays: o, d, id), radiance out
    pt_tab = sum(t.numel() * t.element_size() for t in pk._pack_tables(scene))
    bdpt_tab = sum(t.numel() * t.element_size() for t in bk._pack_tables_bdpt(scene))
    pt_bound, pt_by = bound(512 * 512 * 32 + pt_tab, pt_tests * MT_OPS)
    bdpt_bound, bdpt_by = bound(512 * 512 * 24 + bdpt_tab, bdpt_tests * MT_OPS)
    pt_rays_bound = bound(B * 40 + pt_tab, pt_rays_tests * MT_OPS)
    bdpt_rays_bound = bound(B * 40 + bdpt_tab, bdpt_rays_tests * MT_OPS)
    print(f"bounds: pt_megakernel pixels {pt_bound:.4f} ms ({pt_by}), rays "
          f"{pt_rays_bound[0]:.4f} ms ({pt_rays_bound[1]}); bdpt_megakernel pixels "
          f"{bdpt_bound:.4f} ms ({bdpt_by}), rays {bdpt_rays_bound[0]:.4f} ms "
          f"({bdpt_rays_bound[1]})")
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
        "bound_ms": pt_bound,
        "bound_by": pt_by,
        "library_ms": None,
        "rays_mode_ms": rays_ms,
        "rays_mode_plain_ms": rays_plain_ms,
        "rays_mode_bound_ms": pt_rays_bound[0],
    }, {
        "name": "bdpt_megakernel",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/bdpt_megakernel.cu",
        "replaces": "bpt_tpu/ops/pallas/bdpt_kernel.py:1314",
        "launches": bdpt_launches,
        "max_abs_err": bdpt_err,
        "within_tol": bdpt_frac,
        "ms": bdpt_ms["bdpt"],
        "plain_ms": bdpt_plain_ms["bdpt"],
        "bound_ms": bdpt_bound,
        "bound_by": bdpt_by,
        "library_ms": None,
        "mis_ms": bdpt_ms["bdpt-mis"],
        "mis_plain_ms": bdpt_plain_ms["bdpt-mis"],
        "rays_mode_ms": bdpt_rays_ms,
        "rays_mode_plain_ms": bdpt_rays_plain_ms,
        "rays_mode_bound_ms": bdpt_rays_bound[0],
        "depth80_ms": d80_ms,
    }, {
        "name": "closest_bvh",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/pt_wave.cu",
        "replaces": "bpt_tpu/ops/pallas/cluster_wave.py:340",
        "launches": paged_launches,
        "launches_path": "the coffee render loop with paging forced, 512x512, "
                         "16 spp, depth 10 (render() does not page it: cluster_ok "
                         "holds)",
        "paged_render_ms": paged_render_ms,
        "max_abs_err": a_err,
        "within_tol": a_frac,
        "ms": a_ms,
        "plain_ms": a_plain_primary_ms,
        "bound_ms": a_bound,
        "bound_by": a_by,
        "library_ms": None,
    }, {
        "name": "pt_wave_bounce",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/pt_wave.cu",
        "replaces": "bpt_tpu/ops/pallas/pt_wave.py:326",
        "launches": wave_launches,
        "max_abs_err": wave_err,
        "within_tol": wave_frac,
        "ms": b_ms,
        "plain_ms": b_plain_ms,
        "bound_ms": b_bound,
        "bound_by": b_by,
        "library_ms": None,
        "pt_wave_ms": wave_ms[False],
        "pt_wave_paged_ms": wave_ms[True],
        "pt_wave_plain_ms": wave_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
