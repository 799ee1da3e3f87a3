"""A/B of the persistent megakernels between copies of bpt_tpu_torch, on one
card: the walk mode, and the brute-force kernels.

Each argument is a directory holding a ``bpt_tpu_torch`` package and its
``chip_smoke.py`` (this checkout, or another commit unpacked with ``git
archive``).  The copies' kernels are built first, all at once; then, in the
order given, each copy runs in its own process: it builds the coffee
stand-in from this checkout's ``scenes/coffee`` with that copy's
``chip_smoke.coffee_builder``, and times with CUDA events (the median of
5 batches' means, a batch 3 calls, 10 for the brute BDPT kernels at
512x512 and 30 for the brute PT kernel, after 3 warm-up calls), seed 0:

- 2c: ``pt_megakernel_pixels`` walk mode, coffee 256x256 x 16 spp, depth 10;
- 6c: ``bdpt_megakernel_pixels`` walk mode, coffee bdpt-mis 512x512 x 4
  spp, depth 80 (the main path's one launch), and the main path itself,
  ``render()``: its wall, peak device memory and framebuffer sha256;
- the same kernel at coffee 64x64 x 1 spp, depth 80, bdpt-mis and bdpt
  (whose connections skip the MIS weights' suffix sums);
- 1c / 5c: ``pt_megakernel`` / ``bdpt_megakernel`` (bdpt) walk mode on the
  65,536 rays of the coffee defocus wave (128x128 x 4 spp, depth 10,
  defocus angle 1, as chip_smoke.py phase 19 builds them);
- 2 / 6: the brute-force kernels on the cornell box at 512x512 x 16 spp,
  depth 10 (PT, bdpt, bdpt-mis);
- 1 / 5: ``pt_megakernel`` / ``bdpt_megakernel`` brute force in rays mode
  on the cornell defocus PT / BDPT wave (512x512 x 16 spp, depth 10,
  defocus angle 1: B = 4,194,304, the arguments of chip_smoke.py phase
  13's launches, recorded);
- 1 / 5 on random rays: ``pt_megakernel`` / ``bdpt_megakernel`` (bdpt) at
  B = 65,536, depth 10, origins uniform in [50, 500]^3 (chip_smoke.py
  phase 2's timed cases);
- 6 at depth 80: ``bdpt_megakernel_pixels`` bdpt-mis on the mixed-material
  scene at 64x64 x 4 spp (chip_smoke.py phase 2's case);
- the cornell main paths, ``render()`` at 512x512 x 16 spp, depth 10 with
  PT, bdpt and bdpt-mis: the wall's median of 3 and the framebuffer's
  sha256;

and prints for each case its ms, rays, shadow rays and walk counters and a
sha256 of its outputs (radiance and counters), then the kernels' ptxas
registers and spills, and, where the copy has them, the persistent grids
and the BDPT vertex scratch bytes.  Equal hashes across copies mean
bitwise equal outputs.  Give the copies as A B B A to see the spread:

    python tools/ab_walk_megakernels.py DIR_A DIR_B DIR_B DIR_A
    python tools/ab_walk_megakernels.py --brute DIR_A DIR_B DIR_B DIR_A   # the brute cases only
"""

from __future__ import annotations

import os
import subprocess
import sys

_RUN = r"""
import dataclasses, hashlib, math, os, sys
import numpy as np, torch

DATA, BRUTE_ONLY = sys.argv[1], sys.argv[2] == "brute"
from chip_smoke import coffee_builder, coffee_camera
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.camera import camera_constants, generate_rays
from bpt_tpu_torch.models.render import jnp_raygen, render
from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.scene import builder
from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_builder, cornell_box_camera

log = build.build().with_suffix(".log").read_text().splitlines()
lib = build.load_library()


def ptxas(entry):  # ptxas's stack / spill and register lines of one kernel
    k = next(k for k, l in enumerate(log) if "entry function" in l and entry in l)
    lines = [l.strip() for l in log[k + 1:k + 5] if "spill" in l or "Used" in l]
    return f"{entry}: " + " / ".join(lines)


def timed(fn, reps, batches=5):  # median of the batches' means, after 3 warm-up calls
    out = fn()
    fn(), fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(batches):
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / reps)
    return out, sorted(means)[batches // 2]


def digest(out):
    h = hashlib.sha256()
    for x in out:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pixels(cfg):
    cc = camera_constants(cfg, torch.float32, dev)
    pix = torch.arange(cc.width * cc.height, dtype=torch.int64, device=dev)
    return (pix % cc.width).float(), (pix // cc.width).float(), pix, pk.camera_table(cc)


dev = torch.device("cuda", 0)
key = rng.prng_key(0)
os.chdir(DATA)
runs = {}
if not BRUTE_ONLY:
    coffee = coffee_builder().build(device=dev)
    i, j, pix, cam = pixels(coffee_camera(width=256, spp=16, depth=10))
    runs["2c coffee pt pixels 256x256x16spp d10"] = (lambda: pk.pt_megakernel_pixels(
        coffee, i, j, i * 0, j * 0, pix, cam, key, 10, spp_loop=16, sqrt_spp=4), 3)
    i80, j80, pix80, cam80 = pixels(coffee_camera(spp=4, depth=80, integrator="bdpt-mis"))
    runs["6c coffee bdpt-mis pixels 512x512x4spp d80"] = (lambda: bk.bdpt_megakernel_pixels(
        coffee, i80, j80, pix80, cam80, key, 80, 2, mis=True), 3)
    i64, j64, pix64, cam64 = pixels(coffee_camera(width=64, spp=1, depth=80, integrator="bdpt-mis"))
    for mis in (True, False):
        runs[f"coffee {'bdpt-mis' if mis else 'bdpt'} pixels 64x64x1spp d80"] = (
            lambda mis=mis: bk.bdpt_megakernel_pixels(coffee, i64, j64, pix64, cam64, key, 80, 1,
                                                      mis=mis), 3)
    for name in ("pt", "bdpt"):  # the coffee defocus waves (chip_smoke.py phase 19)
        cam19 = coffee_camera(width=128, spp=4, depth=10, integrator=name)
        cfg19 = dataclasses.replace(cam19, defocus_angle=1.0,
                                    focus_dist=math.dist(cam19.lookfrom, cam19.lookat))
        cc19 = camera_constants(cfg19, torch.float32, dev)
        p19 = torch.arange(128 * 128, dtype=torch.int64, device=dev).repeat(4)
        s19 = torch.arange(4, device=dev).repeat_interleave(128 * 128)
        if name == "pt":
            ids19 = p19 * 4 + s19
            u = rng.wave_uniforms(rng.fold_in(key, 0), ids19, 0, 4, torch.float32)
            o, d = generate_rays(cc19, (p19 % 128).float(), (p19 // 128).float(),
                                 (s19 % 2).float(), (s19 // 2).float(), u)
            a1 = (coffee, Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), ids19, rng.fold_in(key, 1), 10)
            runs["1c coffee pt rays defocus B=65536 d10"] = (lambda: pk.pt_megakernel(*a1), 3)
        else:
            o, d, ids19 = jnp_raygen(cc19, p19, s19, key, torch.float32)
            a5 = (coffee, Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), ids19, key, 10)
            runs["5c coffee bdpt rays defocus B=65536 d10"] = (lambda: bk.bdpt_megakernel(*a5), 3)
cornell = cornell_box(device=dev)
ic, jc, pixc, camc = pixels(dataclasses.replace(cornell_box_camera(), image_width=512,
                                                samples_per_pixel=16))
runs["2 cornell pt pixels 512x512x16spp d10"] = (lambda: pk.pt_megakernel_pixels(
    cornell, ic, jc, ic * 0, jc * 0, pixc, camc, key, 10, spp_loop=16, sqrt_spp=4), 30)
for mis in (False, True):
    runs[f"6 cornell {'bdpt-mis' if mis else 'bdpt'} pixels 512x512x16spp d10"] = (
        lambda mis=mis: bk.bdpt_megakernel_pixels(cornell, ic, jc, pixc, camc, key, 10, 4,
                                                  mis=mis), 10)
# 1 / 5: the cornell defocus PT / BDPT waves, as render() launches them
# (chip_smoke.py phase 13)
for num, name, mod, kname in ((1, "pt", pk, "pt_megakernel"), (5, "bdpt", bk, "bdpt_megakernel")):
    cam5 = cornell_box_camera()
    cfg5 = dataclasses.replace(cam5, image_width=512, samples_per_pixel=16, max_depth=10,
                               integrator=name, defocus_angle=1.0,
                               focus_dist=math.dist(cam5.lookfrom, (277.5, 277.5, 277.5)))
    fn5, calls5 = getattr(mod, kname), []

    def spy5(*a, fn5=fn5, calls5=calls5, **kw):
        calls5.append((a, kw))
        return fn5(*a, **kw)

    spy5.__dict__.update(fn5.__dict__)  # the wrapper counts its launches on its own name
    setattr(mod, kname, spy5)
    render(cornell, cfg5, seed=0)
    setattr(mod, kname, fn5)
    args5, kwargs5 = calls5[0]
    runs[f"{num} cornell {name} rays defocus B={args5[3].numel()} d10"] = (
        lambda fn5=fn5, args5=args5, kwargs5=kwargs5: fn5(*args5, **kwargs5),
        30 if name == "pt" else 3)
# 5 on chip_smoke.py phase 2's random rays
g2 = np.random.default_rng(0)
o2 = torch.from_numpy(g2.uniform(50, 500, (65536, 3)).astype(np.float32)).to(dev)
d2 = torch.from_numpy(g2.normal(size=(65536, 3)).astype(np.float32)).to(dev)
a2 = (cornell, Vec3(*o2.unbind(1)), Vec3(*d2.unbind(1)),
      torch.arange(65536, dtype=torch.int32, device=dev), key, 10)
runs["1 cornell pt rays random B=65536 d10"] = (lambda: pk.pt_megakernel(*a2), 30)
runs["5 cornell bdpt rays random B=65536 d10"] = (lambda: bk.bdpt_megakernel(*a2), 10)
# 6 at depth 80: chip_smoke.py phase 2's mixed-material scene
MS = builder.MaterialSpec
mb = cornell_box_builder()
mb.add_quad((60, 20, 60), (150, 0, 0), (0, 150, 40), MS.metal((0.8, 0.85, 0.9), 0.3))
mb.add_box((340, 0, 80), (460, 120, 200), MS.dielectric(1.5))
mb.add_quad((100, 400, 400), (120, 0, 0), (0, 0, 100), MS.isotropic((0.6, 0.7, 0.5)))
mixed = mb.build(device=dev)
im, jm, pixm, camm = pixels(dataclasses.replace(cornell_box_camera(), image_width=64,
                                                samples_per_pixel=4))
runs["6 mixed bdpt-mis pixels 64x64x4spp d80"] = (lambda: bk.bdpt_megakernel_pixels(
    mixed, im, jm, pixm, camm, key, 80, 2, mis=True), 10)
out = []
for name, (fn, reps) in runs.items():
    res, ms = timed(fn, reps)
    counts = [int(x) for x in res[3:-1]] + res[-1].tolist()
    out.append(f"{name}: {ms:.3f} ms, counters {counts}, sha256 {digest(res)}")
if not BRUTE_ONLY:
    cfg16 = coffee_camera(spp=4, depth=80, integrator="bdpt-mis")
    render(coffee, cfg16, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    r = render(coffee, cfg16, seed=0)
    peak = torch.cuda.max_memory_allocated(dev)
    fb = hashlib.sha256(np.ascontiguousarray(r.framebuffer_sum).tobytes()).hexdigest()[:16]
    out.append(f"6c main path render: wall {r.stats.wall_seconds:.6f} s, peak "
               f"{peak / 2**30:.3f} GiB, framebuffer sha256 {fb}")
for name in ("pt", "bdpt", "bdpt-mis"):  # the cornell main paths, render() as the CLI runs it
    cfg3 = dataclasses.replace(cornell_box_camera(), image_width=512, samples_per_pixel=16,
                               max_depth=10, integrator=name)
    render(cornell, cfg3, seed=0)
    rs = [render(cornell, cfg3, seed=0) for _ in range(3)]
    fb = hashlib.sha256(np.ascontiguousarray(rs[0].framebuffer_sum).tobytes()).hexdigest()[:16]
    walls = sorted(r.stats.wall_seconds for r in rs)
    out.append(f"{2 if name == 'pt' else 6} cornell {name} main path render: wall median "
               f"{walls[1]:.6f} s {[round(w, 6) for w in walls]}, rays "
               f"{rs[0].stats.rays_traced}, framebuffer sha256 {fb}")
# pixels mode's stratum-major rows added into the lane totals in order
# (walk_launches) with no kernel launched, at the cornell chunk's shape
_, sum_ms = timed(lambda: pk.walk_launches(1 << 18, True, 16, lambda k0, nk, out: None, dev), 10)
out.append(f"walk_launches alone, 2^18 lanes x 16 strata (allocation, in-order adds): "
           f"{sum_ms:.3f} ms")
extra = ["ptxas: " + "; ".join(ptxas(e) for e in ("18pt_megakernel_walkE",
                                                 "20bdpt_megakernel_walkE",
                                                 "13pt_megakernelE", "15bdpt_megakernelE"))]
if hasattr(lib, "bpt_bdpt_walk_blocks"):
    with torch.cuda.device(dev):
        pb, bb = lib.bpt_pt_walk_blocks(), lib.bpt_bdpt_walk_blocks()
    extra.append(f"persistent grid: pt {pb} blocks, bdpt {bb} blocks of {pk.WALK_BLOCK}; "
                 f"d80 bdpt-mis vertex scratch {bk.walk_scratch_bytes(bb * pk.WALK_BLOCK, 80, True)} B")
if hasattr(lib, "bpt_pt_brute_blocks"):
    with torch.cuda.device(dev):
        extra.append(f"brute pt persistent grid: {lib.bpt_pt_brute_blocks()} blocks of "
                     f"{pk.WALK_BLOCK}")
if hasattr(lib, "bpt_bdpt_brute_blocks"):
    with torch.cuda.device(dev):
        rb = lib.bpt_bdpt_brute_blocks()
    extra.append(f"brute bdpt persistent grid: {rb} blocks of {pk.WALK_BLOCK}; d10 bdpt-mis "
                 f"vertex scratch {bk.walk_scratch_bytes(rb * pk.WALK_BLOCK, 10, True)} B")
print("\n".join(out + extra))
"""


_BUILD = "from bpt_tpu_torch.ops.kernels import build; build.build()"


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    cases = "brute" if args[:1] == ["--brute"] else "all"
    dirs = args[1:] if cases == "brute" else args
    data = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    copies = {os.path.abspath(d): None for d in dirs}
    for d in copies:  # every copy's kernels at once: nvcc runs in parallel
        copies[d] = subprocess.Popen([sys.executable, "-c", _BUILD], cwd=d,
                                     env=dict(os.environ, PYTHONPATH=d),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for d, proc in copies.items():
        text = proc.communicate()[0]
        if proc.returncode:
            print(f"== {d}: build failed\n{text}", file=sys.stderr)
            return proc.returncode
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", _RUN, data, cases], cwd=os.path.abspath(d),
                              env=dict(os.environ, PYTHONPATH=os.path.abspath(d)),
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(f"== {d} ({card})\n{proc.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
