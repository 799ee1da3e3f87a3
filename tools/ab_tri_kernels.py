"""A/B of the brute-force hit kernels ``closest_tri`` and ``any_tri``
(csrc/intersect.cu) between copies of bpt_tpu_torch, on one card.

Each argument is a directory holding a ``bpt_tpu_torch`` package and its
``chip_smoke.py`` (this checkout, or another commit unpacked with ``git
archive``).  The copies' kernels are built first, all at once; then, in the
order given, each copy runs in its own process, seed 0:

- one warm-up ref_vis render (cornell box, bdpt, ref_vis, 256x256, 64 spp,
  depth 10: the reference binary's own configuration) whose 19
  ``closest_tri`` and 10 ``any_tri`` launches are each timed on their own
  inputs as the render makes them, one at a time (median of 5 batches of
  4 calls after a warm-up call, and the batches' spread): B, live lanes,
  ms, the bound (as ``chip_smoke.py`` phase 12 computes it), a sha256 of
  the outputs; for the shadow waves also the live lanes of each light row
  (the wave is [S_l, B] flattened row by row) and the mean number of
  Möller–Trumbore tests a live lane runs (``chip_smoke.any_tests``); then
  the sums over the render;
- the ref_vis render's wall (median of 3 after that warm-up) and its
  framebuffer's sha256;
- the CLI's ``--f64`` render (64x64, 4 spp, its BDPT default) through the
  float64 kernels: wall and framebuffer sha256;
- ``chip_smoke.py`` phase 11's lanes (65,613 random rays with per-lane
  intervals) in the cornell box and in the 256-triangle soup, at float32
  and float64: each kernel's ms and output sha256;
- ptxas's registers and spills of the four instantiations and, where the
  copy has it, each kernel's persistent grid.

Equal hashes across copies mean bitwise equal outputs.  Give the copies as
A B B A to see the spread:

    mkdir -p build/ab/parent && git archive <commit> bpt_tpu_torch chip_smoke.py \\
        | tar -x -C build/ab/parent
    python tools/ab_tri_kernels.py build/ab/parent . . build/ab/parent
"""

from __future__ import annotations

import os
import subprocess
import sys

_BUILD = "from bpt_tpu_torch.ops.kernels import build; build.build()"

_RUN = r"""
import dataclasses, hashlib, statistics, time
import numpy as np, torch

from chip_smoke import MT_OPS, any_tests, bound, tri_lanes, tri_soup
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels import intersect as ki
from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

log = build.build().with_suffix(".log").read_text().splitlines()
lib = build.load_library()
dev = torch.device("cuda", 0)


def ptxas(entry):  # ptxas's stack / spill and register lines of the kernels named so
    found = []
    for k, l in enumerate(log):
        if "entry function" in l and entry in l:
            name = l.split("'")[1]
            lines = [x.strip() for x in log[k + 1:k + 5] if "spill" in x or "Used" in x]
            found.append(f"{name}: " + " / ".join(lines))
    return "; ".join(found)


def med_ms(fn, batches=5, reps=4):
    # (median, min, max) of the batches' mean ms a call, after a warm-up call
    fn()
    ms = []
    for _ in range(batches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop) / reps)
    return statistics.median(ms), min(ms), max(ms)


def digest(out):
    h = hashlib.sha256()
    for x in (out if isinstance(out, (tuple, list)) else (out,)):
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dense(scene, o, d, tmin, tmax):
    # the lanes as the kernels read them: contiguous [B] tensors
    c = lambda x: torch.broadcast_to(torch.as_tensor(x, dtype=scene.dtype, device=dev),
                                     o.x.shape).contiguous()
    return scene, Vec3(*map(c, o)), Vec3(*map(c, d)), c(tmin), c(tmax)


def table_bytes(scene):
    return scene.num_tris * 9 * scene.v0.element_size()


launches = {"closest_tri": [], "any_tri": []}
rows_of = []  # B of a camera-side launch: a shadow wave's row length


def spy_on(name):
    fn = getattr(ki, name)

    def spy(*args):
        a = dense(*args)
        scene, o, d, tmin, tmax = a
        out = fn(*a)
        torch.cuda.synchronize()
        B, live = int(tmin.shape[0]), int((tmin <= tmax).sum())
        ms = med_ms(lambda: fn(*a))
        e = tmin.element_size()
        if name == "closest_tri":
            rows_of.append(B)
            b = bound(B * (2 * e + 3 * e + 4) + live * 6 * e + table_bytes(scene),
                      live * scene.num_tris * MT_OPS)
            extra = ""
        else:
            tests = any_tests(scene, o, d, tmin, tmax)
            b = bound(B * (2 * e + 1) + live * 6 * e + table_bytes(scene), tests * MT_OPS)
            R = rows_of[0] if rows_of and B % rows_of[0] == 0 else B
            per_row = (tmin <= tmax).view(B // R, R).sum(dim=1).tolist()
            extra = (f", tests a live lane {tests / max(live, 1):.3f}, live lanes a light row "
                     f"{per_row}")
        launches[name].append((B, live, ms, b))
        print(f"  {name} launch {len(launches[name]) - 1}: B={B} live {live}: {ms[0]:.4f} ms "
              f"[{ms[1]:.4f}-{ms[2]:.4f}], bound {b[0]:.4f} ms ({b[1]}), sha256 "
              f"{digest(out)}{extra}", flush=True)
        del a, o, d, tmin, tmax
        return out

    spy.__dict__.update(fn.__dict__)
    setattr(ki, name, spy)
    return fn


# ---- the ref_vis render: every launch of its warm-up, then its wall
scene = cornell_box(device=dev)
cfg = dataclasses.replace(cornell_box_camera(), image_width=256, samples_per_pixel=64,
                          max_depth=10, integrator="bdpt", ref_vis=True)
print("ref_vis 256x256x64spp d10, the warm-up render's launches, each on its own inputs:")
fc, fa = spy_on("closest_tri"), spy_on("any_tri")
render(scene, cfg, seed=0)
ki.closest_tri, ki.any_tri = fc, fa
for name, rows in launches.items():
    print(f"{name}, the render's {len(rows)} launches: sum {sum(r[2][0] for r in rows):.4f} "
          f"ms, live {sum(r[1] for r in rows)} of {sum(r[0] for r in rows)} lanes, bound "
          f"{sum(r[3][0] for r in rows):.4f} ms")


def renders(sc, cfg, n=3):
    render(sc, cfg, seed=0)  # warm-up
    rs = [render(sc, cfg, seed=0) for _ in range(n)]
    fb = hashlib.sha256(np.ascontiguousarray(rs[0].framebuffer_sum).tobytes()).hexdigest()[:16]
    same = all(np.array_equal(r.framebuffer_sum, rs[0].framebuffer_sum) for r in rs[1:])
    walls = [r.stats.wall_seconds for r in rs]
    st = rs[0].stats
    return (f"wall median {statistics.median(walls):.6f} s {[round(w, 6) for w in walls]}, "
            f"rays {st.rays_traced}, shadow rays {st.shadow_rays}, framebuffer sha256 {fb}"
            + ("" if same else " (renders differ)"))


print(f"ref_vis render: {renders(scene, cfg)}", flush=True)
f64 = cornell_box(device=dev, dtype=torch.float64)
cfg64 = dataclasses.replace(cornell_box_camera(), image_width=64, aspect_ratio=1.0,
                            samples_per_pixel=4)
print(f"--f64 64x64x4spp render: {renders(f64, cfg64)}", flush=True)

# ---- chip_smoke.py phase 11's lanes
for dtype in (torch.float32, torch.float64):
    for sc_name, sc in (("cornell", cornell_box(device=dev, dtype=dtype)),
                        ("256-triangle soup", tri_soup(254, 3, dev, dtype))):
        lanes = tri_lanes(65_536 + 77, 5, dev, dtype)
        for name in ("closest_tri", "any_tri"):
            fn = getattr(ki, name)
            out = fn(sc, *lanes)
            ms = med_ms(lambda: fn(sc, *lanes))
            print(f"{name} phase 11 lanes, {sc_name} {dtype}: B={lanes[3].numel()}: "
                  f"{ms[0]:.4f} ms [{ms[1]:.4f}-{ms[2]:.4f}], sha256 {digest(out)}")

print("ptxas: " + "; ".join(ptxas(e) for e in ("closest_tri", "any_tri")))
if hasattr(lib, "bpt_tri_blocks"):
    with torch.cuda.device(dev):
        grids = {(f, a): lib.bpt_tri_blocks(f, a) for f in (0, 1) for a in (0, 1)}
    print("persistent grids (blocks of 128 threads): " + ", ".join(
        f"{'any' if a else 'closest'}_tri {'f64' if f else 'f32'} {g}"
        for (f, a), g in grids.items()))
"""


def main(argv=None) -> int:
    dirs = sys.argv[1:] if argv is None else argv
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
        path = os.path.abspath(d)
        proc = subprocess.run([sys.executable, "-c", _RUN], cwd=path,
                              env=dict(os.environ, PYTHONPATH=path),
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        print(f"== {d} ({card})\n{proc.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
