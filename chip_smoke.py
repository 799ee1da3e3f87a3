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

Each phase prints its seconds.  The second-to-last line is a JSON object
describing the kernels; the last is {"ok": true, "device": {...}}.  Any
failure exits non-zero, and so does a machine without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

RTOL, ATOL, BDPT_ATOL, MIN_FRAC = 1e-4, 1e-6, 1e-5, 0.999
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
        "mis_ms": bdpt_ms["bdpt-mis"],
        "mis_plain_ms": bdpt_plain_ms["bdpt-mis"],
        "rays_mode_ms": bdpt_rays_ms,
        "rays_mode_plain_ms": bdpt_rays_plain_ms,
        "depth80_ms": d80_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
