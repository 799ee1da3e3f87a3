"""A/B of the megakernels' volume modes (csrc/volume.cuh's free-flight
override) between copies of bpt_tpu_torch, on one card.

Each argument is a directory holding a ``bpt_tpu_torch`` package and its
``chip_smoke.py`` (this checkout, another commit unpacked with ``git
archive``, or a copy from ``tools/volume_variants.py``).  The copies'
kernels are built first, all at once; then, in the order given, each copy
runs in its own process from this checkout's ``scenes/``, seed 0, timing
with CUDA events (the median of 5 batches' means after 3 warm-up calls):

- 2v / 6v: ``pt_megakernel_pixels`` and ``bdpt_megakernel_pixels`` (bdpt,
  bdpt-mis) on ``scenes/cornell_smoke.yaml`` at its own 256x256 x 64 spp,
  depth 16: the main path's one launch a render, as chip_smoke.py phase 24c
  builds it;
- 1v / 5v: ``pt_megakernel`` and ``bdpt_megakernel`` (bdpt, bdpt-mis) in
  rays mode on cornell_smoke at chip_smoke.VOL_RAYS, injected draws and the
  stream (phase 24b's rays);
- 1cv / 5cv / 2cv / 6cv: the walk mode's volume kernels on
  chip_smoke.big_volume_scene at VOL_BIG_RAYS (pt both draw modes, bdpt
  injected, bdpt-mis stream) and 32x32 x 4 spp (pt, bdpt-mis), and 9v:
  ``pt_wave`` at VOL_BIG_WAVE, untextured and with a checker-textured
  volume (``pt_wave_bounce_vol``);
- the main paths, ``render()`` of cornell_smoke with pt, bdpt and bdpt-mis:
  the wall's median of 3 after a warm-up, the peak device memory and the
  framebuffer's sha256;

and prints for each case its ms, rays, shadow rays and counters and a
sha256 of its outputs (radiance and counters), then the volume kernels'
ptxas registers, spills and shared bytes.  Equal hashes across copies mean
bitwise equal outputs.  A copy built by ``tools/volume_variants.py E1+split``
also prints, for the three main-path launches, where its lanes' cycles go
(clock64 accumulators) and how many warps could skip each volume.  Give
the copies as A B B A to see the spread:

    mkdir -p build/ab/parent && git archive <commit> bpt_tpu_torch chip_smoke.py \\
        | tar -x -C build/ab/parent
    python tools/ab_volume_kernels.py build/ab/parent . . build/ab/parent
"""

from __future__ import annotations

import os
import subprocess
import sys

_RUN = r"""
import ctypes, dataclasses, hashlib, os, sys
import numpy as np, torch

DATA = sys.argv[1]
import chip_smoke as cs
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.models.pt import NU
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.ops.kernels import pt_wave as pw
from bpt_tpu_torch.scene.loader import load_scene_from_yaml
from bpt_tpu_torch.scene.textures import TextureSpec as TS

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


dev = torch.device("cuda", 0)
key = rng.prng_key(0)
os.chdir(DATA)
runs = {}
smoke = load_scene_from_yaml("scenes/cornell_smoke.yaml", device=dev, verbose=False)
scene, cam_cfg = smoke.scene, smoke.camera
npx, S, depth = cam_cfg.image_width * cam_cfg.image_height, cam_cfg.sqrt_spp, cam_cfg.max_depth
cc = camera_constants(cam_cfg, torch.float32, dev)
pix = torch.arange(npx, dtype=torch.int64, device=dev)
i, j = (pix % cam_cfg.image_width).float(), (pix // cam_cfg.image_width).float()
cam = pk.camera_table(cc)
main = {
    "2v cornell_smoke pt pixels 256x256x64spp d16": (lambda: pk.pt_megakernel_pixels(
        scene, i, j, i * 0, j * 0, pix, cam, key, depth, spp_loop=S * S, sqrt_spp=S), 10, "pt"),
    "6v cornell_smoke bdpt pixels 256x256x64spp d16": (lambda: bk.bdpt_megakernel_pixels(
        scene, i, j, pix, cam, key, depth, S), 3, "bdpt"),
    "6v cornell_smoke bdpt-mis pixels 256x256x64spp d16": (lambda: bk.bdpt_megakernel_pixels(
        scene, i, j, pix, cam, key, depth, S, mis=True), 3, "bdpt"),
}
for name, (fn, reps, _) in main.items():
    runs[name] = (fn, reps)
# phase 24b's rays: B rays from the camera point at targets in the box
g = np.random.default_rng(24)
B, rdepth = cs.VOL_RAYS
o3 = torch.tensor([278.0, 278.0, -800.0], device=dev).expand(B, 3)
tgt = torch.from_numpy(g.uniform(50, 500, (B, 3)).astype(np.float32)).to(dev)
ov, dv = Vec3(*o3.unbind(1)), Vec3(*(tgt - o3).unbind(1))
ids = torch.arange(B, dtype=torch.int32, device=dev)
ubuf = torch.from_numpy(g.uniform(size=(rdepth * (NU + scene.num_volumes), B))
                        .astype(np.float32)).to(dev)
ub = torch.from_numpy(g.uniform(size=(bk.n_uniform_slots(rdepth, scene.num_volumes), B))
                      .astype(np.float32)).to(dev)
ra = (scene, ov, dv, ids, key, rdepth)
for mode, u, u5 in (("injected", ubuf, ub), ("stream", None, None)):
    runs[f"1v cornell_smoke pt rays {mode} B={B} d{rdepth}"] = (
        lambda u=u: pk.pt_megakernel(*ra, uniforms=u), 30)
    for mis in (False, True):
        runs[f"5v cornell_smoke {'bdpt-mis' if mis else 'bdpt'} rays {mode} B={B} d{rdepth}"] = (
            lambda u5=u5, mis=mis: bk.bdpt_megakernel(*ra, uniforms=u5, mis=mis), 10)
# the walk mode and the wave on the 964-triangle scene with a volume box
big = cs.big_volume_scene(dev)
Bw, dw = cs.VOL_BIG_RAYS
ob = torch.tensor([0.0, 2.0, 6.0], device=dev).expand(Bw, 3)
tb = torch.from_numpy(np.c_[g.uniform(-2, 2, Bw), g.uniform(0, 3, Bw),
                            np.zeros(Bw)].astype(np.float32)).to(dev)
wa = (big, Vec3(*ob.unbind(1)), Vec3(*(tb - ob).unbind(1)),
      torch.arange(Bw, dtype=torch.int32, device=dev), key, dw)
ub_pt = torch.from_numpy(g.uniform(size=(dw * (NU + 1), Bw)).astype(np.float32)).to(dev)
ub_bd = torch.from_numpy(g.uniform(size=(bk.n_uniform_slots(dw, 1), Bw))
                         .astype(np.float32)).to(dev)
runs[f"1cv big volume pt rays injected B={Bw} d{dw}"] = (
    lambda: pk.pt_megakernel(*wa, uniforms=ub_pt), 10)
runs[f"1cv big volume pt rays stream B={Bw} d{dw}"] = (lambda: pk.pt_megakernel(*wa), 10)
runs[f"5cv big volume bdpt rays injected B={Bw} d{dw}"] = (
    lambda: bk.bdpt_megakernel(*wa, uniforms=ub_bd), 10)
runs[f"5cv big volume bdpt-mis rays stream B={Bw} d{dw}"] = (
    lambda: bk.bdpt_megakernel(*wa, mis=True), 10)
Wb = 32
ccb = camera_constants(cs.big_volume_camera(Wb, 4, dw, "bdpt"), torch.float32, dev)
pixb = torch.arange(Wb * Wb, dtype=torch.int64, device=dev)
ib, jb = (pixb % Wb).float(), (pixb // Wb).float()
camb = pk.camera_table(ccb)
runs[f"2cv big volume pt pixels {Wb}x{Wb}x4spp d{dw}"] = (lambda: pk.pt_megakernel_pixels(
    big, ib, jb, ib * 0, jb * 0, pixb, camb, key, dw, spp_loop=4, sqrt_spp=2), 10)
runs[f"6cv big volume bdpt-mis pixels {Wb}x{Wb}x4spp d{dw}"] = (
    lambda: bk.bdpt_megakernel_pixels(big, ib, jb, pixb, camb, key, dw, 2, mis=True), 10)
Bv, dvw = cs.VOL_BIG_WAVE
key_pt = rng.fold_in(key, 1)
for tex_name, tex in (("untextured", None),
                      ("checker-textured", TS.checker(0.35, (0.9, 0.3, 0.2), (0.2, 0.4, 0.9)))):
    sc = cs.big_volume_scene(dev, texture=tex)
    ow = torch.tensor([0.0, 2.0, 6.0], device=dev).expand(Bv, 3)
    tw = torch.from_numpy(np.c_[g.uniform(-2, 2, Bv), g.uniform(0, 3, Bv),
                                np.zeros(Bv)].astype(np.float32)).to(dev)
    wv = (sc, Vec3(*ow.unbind(1)), Vec3(*(tw - ow).unbind(1)),
          torch.arange(Bv, dtype=torch.int32, device=dev), key_pt, dvw)
    runs[f"9v big volume pt_wave {tex_name} B={Bv} d{dvw}"] = (lambda wv=wv: pw.pt_wave(*wv), 5)
out = []
for name, (fn, reps) in runs.items():
    res, ms = timed(fn, reps)
    counts = [int(x) for x in res[3:-1]] + res[-1].tolist()
    out.append(f"{name}: {ms:.3f} ms, counters {counts}, sha256 {digest(res)}")
# the split copy's clock64 accumulators on one more launch of each main case
if hasattr(lib, "bpt_vclk_take_pt"):
    slots = ("lane cycles", "closest hits", "first probes", "second probes", "draws",
             "free_flight", "connections", "shadow sweeps", "warp-volume events",
             "warp-volumes with no box open", "active lanes at them", "open lanes at them",
             "lane first probes", "lane second probes", "lane draws", "free_flight calls")
    for name, (fn, _, which) in main.items():
        take = getattr(lib, f"bpt_vclk_take_{which}")
        take.argtypes, take.restype = [ctypes.c_void_p], ctypes.c_int
        buf = (ctypes.c_ulonglong * 16)()
        torch.cuda.synchronize()
        build.check(take(ctypes.addressof(buf)), "vclk take")
        fn()
        torch.cuda.synchronize()
        build.check(take(ctypes.addressof(buf)), "vclk take")
        vals = list(buf)
        tot = max(vals[0], 1)
        shares = ", ".join(f"{slots[k]} {vals[k]} ({100.0 * vals[k] / tot:.2f}%)"
                           for k in range(1, 8))
        counts = ", ".join(f"{slots[k]} {vals[k]}" for k in range(8, 16))
        out.append(f"split {name}: {slots[0]} {vals[0]}; {shares}; {counts}")
for integrator in pk.INTEGRATORS:  # the main paths, render() as the CLI runs it
    cfg = dataclasses.replace(cam_cfg, integrator=integrator)
    render(scene, cfg, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    rs = [render(scene, cfg, seed=0) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev)
    fb = hashlib.sha256(np.ascontiguousarray(rs[0].framebuffer_sum).tobytes()).hexdigest()[:16]
    walls = sorted(r.stats.wall_seconds for r in rs)
    out.append(f"cornell_smoke {integrator} main path render: wall median {walls[1]:.6f} s "
               f"{[round(w, 6) for w in walls]}, rays {rs[0].stats.rays_traced}, shadow rays "
               f"{rs[0].stats.shadow_rays}, peak {peak / 2**30:.4f} GiB, framebuffer sha256 {fb}")
out.append("ptxas: " + "; ".join(ptxas(e) for e in (
    "17pt_megakernel_volE", "19bdpt_megakernel_volE", "22pt_megakernel_walk_volE",
    "24bdpt_megakernel_walk_volE", "18pt_wave_bounce_volE")))
print("\n".join(out))
"""


_BUILD = "from bpt_tpu_torch.ops.kernels import build; build.build()"


def main(argv=None) -> int:
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    data = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    copies = {os.path.abspath(d): None for d in dirs}
    for d in copies:  # every copy's kernels at once: nvcc runs in parallel
        copies[d] = subprocess.Popen([sys.executable, "-c", _BUILD], cwd=d,
                                     env=dict(os.environ, PYTHONPATH=d),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = set()  # a copy that fails is reported, and the others still run
    for d, proc in copies.items():
        text = proc.communicate()[0]
        if proc.returncode:
            print(f"== {d}: build failed\n{text[-4000:]}", flush=True)
            failed.add(d)
    for d in (d for d in dirs if os.path.abspath(d) not in failed):
        proc = subprocess.run([sys.executable, "-c", _RUN, data], cwd=os.path.abspath(d),
                              env=dict(os.environ, PYTHONPATH=os.path.abspath(d)),
                              capture_output=True, text=True)
        print(f"== {d} ({card})\n{proc.stdout.strip()}", flush=True)
        if proc.returncode:
            print(f"== {d}: exit {proc.returncode}\n{proc.stderr[-4000:]}", flush=True)
            failed.add(os.path.abspath(d))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
