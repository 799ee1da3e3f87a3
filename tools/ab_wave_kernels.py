"""A/B of the BVH wave kernels ``closest_bvh``, ``any_bvh`` and
``pt_wave_bounce`` (csrc/pt_wave.cu) between copies of bpt_tpu_torch, on
one card.

Each argument is a directory holding a ``bpt_tpu_torch`` package and its
``chip_smoke.py`` (this checkout, or another commit unpacked with ``git
archive``).  The copies' kernels are built first, all at once; then, in the
order given, each copy runs in its own process: it builds the coffee
stand-in from this checkout's ``scenes/coffee`` with that copy's
``chip_smoke.coffee_builder`` and times with CUDA events (mean of 5 calls
after a warm-up; 3 for the bounces), seed 0:

- ``closest_bvh`` on each of the 19 launches of one coffee bdpt-mis
  512x512 / 4 spp / depth 10 render on the BDPT wave route (camera bounce 1
  is launch 1, B = 1,048,576), their sum, and on 1,048,576 random rays in
  the scene's bounds;
- the wrapper ``pt_wave_bounce`` (the walk and the shade of a bounce) on
  each of the 10 bounces of one coffee PT 512x512 / 16 spp / depth 10
  render and their sum, at bounce 0 on chip_smoke.py
  phase 8's state (B = 4,194,304), and in paged mode there (over
  ``closest_bvh``'s hits);
- the two renders' walls (median of 3 after a warm-up) and framebuffer
  sha256;
- ``any_bvh`` on each of the 10 shadow waves of the same bdpt-mis render
  (the shadow wave of camera vertex 1 is launch 1, B = 10,485,760) and
  their sum;
- the walk-mode megakernels on coffee (PT pixels 128x128 x 4 spp, depth 10;
  bdpt-mis pixels 64x64 x 1 spp, depth 80), which this A/B leaves as they
  are;
- the float64 walks bvh64<false> / bvh64<true> (closest_bvh / any_bvh on
  a float64 scene) on each of the 19 closest and 10 any launches of one
  float64 coffee bdpt-mis 512x512 / 4 spp / depth 10 render through the
  stratum loop (camera bounce 1 is closest launch 1, the shadow wave of
  camera vertex 1 any launch 1), mean of 10 calls, their sums, the
  render's wall and the float64 persistent grids; and lone walks, rays of
  the last closest launch and of any launch 1 each walked alone (B = 1),
  with the least-squares ms a node visit and a triangle test;

and prints for each case its ms, live lanes and a sha256 of its outputs and
counters, then ptxas's registers and spills of the three kernels and of
the float64 walks, a sha256 of each float32 kernel's SASS (cuobjdump), the
float64 walks' SASS instructions by kind and, where the copy has them,
closest_bvh's and any_bvh's persistent grids.  Equal hashes across
copies mean bitwise equal outputs.  ``--f64-only``, as the first argument, runs the float64 cases
alone.  Give the copies as A B B A to see the spread:

    mkdir -p build/ab/parent && git archive <commit> bpt_tpu_torch chip_smoke.py \\
        | tar -x -C build/ab/parent
    python tools/ab_wave_kernels.py [--f64-only] build/ab/parent . . build/ab/parent
"""

from __future__ import annotations

import os
import subprocess
import sys

_BUILD = "from bpt_tpu_torch.ops.kernels import build; build.build()"

_HEAD = r"""
import hashlib, os, statistics, subprocess, sys
import numpy as np, torch

DATA = sys.argv[1]
from chip_smoke import coffee_builder, coffee_camera, wave_rays
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.ops.kernels import pt_wave as pw
from bpt_tpu_torch.core.vec3 import Vec3

log = build.build().with_suffix(".log").read_text().splitlines()
lib = build.load_library()


def ptxas(entry):  # ptxas's stack / spill and register lines of the kernels named so
    found = []
    for k, l in enumerate(log):
        if "entry function" in l and entry in l:
            name = l.split("'")[1]
            lines = [x.strip() for x in log[k + 1:k + 5] if "spill" in x or "Used" in x]
            found.append(f"{name}: " + " / ".join(lines))
    return "; ".join(found)


def timed(fn, reps):
    out = fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def digest(out):
    h = hashlib.sha256()
    for x in out:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def recording(name, pick):
    # records pick(args, kw) of every call of pw.<name> (copies of its
    # tensors); the calls go through
    fn, calls = getattr(pw, name), []

    def spy(*args, **kw):
        calls.append(pick(args, kw))
        return fn(*args, **kw)

    spy.__dict__.update(fn.__dict__)
    setattr(pw, name, spy)
    return fn, calls


def renders(scene, cfg):
    render(scene, cfg, seed=0)  # warm-up
    rs = [render(scene, cfg, seed=0) for _ in range(3)]
    fb = hashlib.sha256(np.ascontiguousarray(rs[0].framebuffer_sum).tobytes()).hexdigest()[:16]
    same = all(np.array_equal(r.framebuffer_sum, rs[0].framebuffer_sum) for r in rs[1:])
    walls = [r.stats.wall_seconds for r in rs]
    return (f"wall median {statistics.median(walls):.6f} s {[round(w, 6) for w in walls]}, "
            f"rays {rs[0].stats.rays_traced}, framebuffer sha256 {fb}"
            + ("" if same else " (renders differ)"))


dev = torch.device("cuda", 0)
key = rng.prng_key(0)
os.chdir(DATA)
out = []
"""

_F32 = r"""
coffee = coffee_builder().build(device=dev)


# ---- coffee bdpt-mis 512x512 / 4 spp / d10: its 19 closest_bvh launches
cfg_b = coffee_camera(spp=4, integrator="bdpt-mis")
render(coffee, cfg_b, seed=0)
clone = lambda vs: tuple(x.clone() for x in vs)
fc, closest_calls = recording("closest_bvh", lambda a, kw: (clone(a[1]), clone(a[2]),
                                                            a[3].clone()))
fa, any_calls = recording("any_bvh", lambda a, kw: (clone(a[1]), clone(a[2]), a[3].clone()))
render(coffee, cfg_b, seed=0)
pw.closest_bvh, pw.any_bvh = fc, fa
out.append(f"coffee bdpt-mis 512x512x4spp d10 render: {renders(coffee, cfg_b)}")
total, lines = 0.0, []
for n, (o, d, act) in enumerate(closest_calls):
    res, ms = timed(lambda: pw.closest_bvh(coffee, Vec3(*o), Vec3(*d), act), 5)
    total += ms
    lines.append(f"  closest_bvh launch {n}: B={act.numel()} live {int(act.sum())}: "
                 f"{ms:.3f} ms, counters {res[4].tolist()}, sha256 {digest(res)}")
out.append(f"closest_bvh, the render's {len(closest_calls)} launches: sum {total:.3f} ms")
out += lines
total, lines = 0.0, []
for n, (o, d, tmax) in enumerate(any_calls):
    res, ms = timed(lambda: pw.any_bvh(coffee, Vec3(*o), Vec3(*d), tmax), 5)
    total += ms
    lines.append(f"  any_bvh launch {n}: B={tmax.numel()} live {int((tmax > 0).sum())}: "
                 f"{ms:.3f} ms, counters {res[1].tolist()}, sha256 {digest(res)}")
out.append(f"any_bvh, the render's {len(any_calls)} launches: sum {total:.3f} ms")
out += lines
del closest_calls, any_calls
g = np.random.default_rng(0)
B = 1 << 20
lo, hi = (x.cpu().numpy() for x in (coffee.bvh_min[0], coffee.bvh_max[0]))
o_r = Vec3(*torch.from_numpy(g.uniform(lo, hi, (B, 3)).astype(np.float32)).to(dev).unbind(1))
d_r = Vec3(*torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev).unbind(1))
act = torch.ones(B, dtype=torch.bool, device=dev)
res, ms = timed(lambda: pw.closest_bvh(coffee, o_r, d_r, act), 5)
out.append(f"closest_bvh, {B} random rays in the scene's bounds: {ms:.3f} ms, counters "
           f"{res[4].tolist()}, sha256 {digest(res)}")
del o_r, d_r, act, res

# ---- coffee PT 512x512 / 16 spp / d10: its 10 pt_wave_bounce launches
cfg_p = coffee_camera()
key_pt = rng.fold_in(key, 1)
render(coffee, cfg_p, seed=0)
fb_, bounce_calls = recording("pt_wave_bounce", lambda a, kw: (a[1].clone(), a[2].clone(),
                                                               a[3], a[4], kw.get("tables")))
render(coffee, cfg_p, seed=0)
pw.pt_wave_bounce = fb_
out.append(f"coffee pt 512x512x16spp d10 render: {renders(coffee, cfg_p)}")
total, lines = 0.0, []
for n, (state, rid, k_, b_, tab) in enumerate(bounce_calls):
    res, ms = timed(lambda: pw.pt_wave_bounce(coffee, state, rid, k_, b_, tables=tab), 3)
    total += ms
    lines.append(f"  pt_wave_bounce bounce {b_}: B={rid.numel()} live "
                 f"{int((state[pw.ALIVE] > 0.5).sum())}: {ms:.3f} ms, counters "
                 f"{res[1].tolist()}, sha256 {digest(res)}")
out.append(f"pt_wave_bounce, the render's {len(bounce_calls)} launches: sum {total:.3f} ms")
out += lines
del bounce_calls
# bounce 0 on chip_smoke.py phase 8's state, walking and paged
ccc = camera_constants(coffee_camera(), torch.float32, dev)
o_m, d_m, ids_m = wave_rays(ccc, torch.arange(512 * 512, device=dev), 16, key, dev)
state = torch.empty((pw.STATE_ROWS, ids_m.numel()), device=dev)
state[pw.OX:pw.DX + 3] = torch.stack([*o_m, *d_m])
state[pw.THR:pw.THR + 3] = 1.0
state[pw.RAD:pw.RAD + 3] = 0.0
state[pw.ALIVE] = 1.0
tables = pw.pack_bvh(coffee)
res, ms = timed(lambda: pw.pt_wave_bounce(coffee, state, ids_m, key_pt, 0, tables=tables), 5)
out.append(f"pt_wave_bounce at the main path's bounce 0 (B={ids_m.numel()}): {ms:.3f} ms, "
           f"counters {res[1].tolist()}, sha256 {digest(res)}")
t, tri = pw.closest_bvh(coffee, o_m, d_m, state[pw.ALIVE] > 0.5)[:2]
res, ms = timed(lambda: pw.pt_wave_bounce(coffee, state, ids_m, key_pt, 0, (t, tri),
                                          tables=tables), 5)
out.append(f"pt_wave_bounce paged at bounce 0: {ms:.3f} ms, counters {res[1].tolist()}, "
           f"sha256 {digest(res)}")
del state, res, t, tri, o_m, d_m


# ---- the walk-mode megakernels (untouched by this A/B)
def pixels(cfg):
    cc = camera_constants(cfg, torch.float32, dev)
    pix = torch.arange(cc.width * cc.height, dtype=torch.int64, device=dev)
    return (pix % cc.width).float(), (pix // cc.width).float(), pix, pk.camera_table(cc)


i, j, pix, cam = pixels(coffee_camera(width=128, spp=4, depth=10))
res, ms = timed(lambda: pk.pt_megakernel_pixels(coffee, i, j, i * 0, j * 0, pix, cam, key, 10,
                                                spp_loop=4, sqrt_spp=2), 3)
out.append(f"pt_megakernel_pixels walk mode, coffee 128x128x4spp d10: {ms:.3f} ms, "
           f"sha256 {digest(res)}")
i, j, pix, cam = pixels(coffee_camera(width=64, spp=1, depth=80, integrator="bdpt-mis"))
res, ms = timed(lambda: bk.bdpt_megakernel_pixels(coffee, i, j, pix, cam, key, 80, 1,
                                                  mis=True), 3)
out.append(f"bdpt_megakernel_pixels walk mode, coffee bdpt-mis 64x64x1spp d80: {ms:.3f} ms, "
           f"sha256 {digest(res)}")
"""

_F64 = r"""
# ---- float64 coffee bdpt-mis 512x512 / 4 spp / d10 (the stratum loop): its
# 19 closest_bvh and 10 any_bvh float64 launches (bvh64<false> / <true>)
coffee64 = coffee_builder().build(device=dev, dtype=torch.float64)
copy = lambda vs: tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in vs)
cfg_b = coffee_camera(spp=4, integrator="bdpt-mis")
render(coffee64, cfg_b, seed=0)
fc, closest_calls = recording("closest_bvh", lambda a, kw: (copy(a[1]), copy(a[2]), copy(a[3:])))
fa, any_calls = recording("any_bvh", lambda a, kw: (copy(a[1]), copy(a[2]), copy(a[3:])))
render(coffee64, cfg_b, seed=0)
pw.closest_bvh, pw.any_bvh = fc, fa
out.append(f"float64 coffee bdpt-mis 512x512x4spp d10 render: {renders(coffee64, cfg_b)}")
# the bound of a launch: chip_smoke.py phase 26's (bytes of the lanes and
# the walk tables over 3.35 TB/s, or the walk's FP64 operations from its
# counters over 34 TFLOP/s, whichever is larger)
from chip_smoke import MT_OPS, SLAB_OPS, bound64, walk64_bytes

# the walk tables' bytes as a walk needs them (box and links 56 B a node,
# 72 B a triangle: chip_smoke.walk64_table_bytes), whatever a copy's layout
table_bytes = 56 * int(coffee64.bvh_min.shape[0]) + 72 * int(coffee64.num_tris)
for name, calls in (("closest_bvh", closest_calls), ("any_bvh", any_calls)):
    fn = getattr(pw, name)
    total, bound_total, lines = 0.0, 0.0, []
    for n, (o, d, rest) in enumerate(calls):
        res, ms = timed(lambda: fn(coffee64, Vec3(*o), Vec3(*d), *rest), 10)
        total += ms
        live = int(rest[0].sum()) if name == "closest_bvh" else int((rest[0] > 0).sum())
        c = res[-1].tolist()
        bound = bound64(walk64_bytes(name.split("_")[0], rest[0]) + table_bytes,
                        c[0] * SLAB_OPS + c[2] * MT_OPS)[0]
        bound_total += bound
        lines.append(f"  float64 {name} launch {n}: B={rest[0].numel()} live {live}: "
                     f"{ms:.3f} ms, bound {bound:.4f} ms, counters {c}, sha256 {digest(res)}")
    out.append(f"float64 {name}, the render's {len(calls)} launches: sum {total:.3f} ms, "
               f"bound {bound_total:.4f} ms (walk tables {table_bytes} bytes)")
    out += lines


def lone_walks(name, call, pick=256, keep=24):
    # rays of one launch walked alone (B = 1): the `keep` longest of the
    # first `pick` live lanes, each timed; ms ~ a + b * nodes + c * tests
    fn = getattr(pw, name)
    o, d, rest = call
    live = rest[0] if name == "closest_bvh" else rest[0] > 0
    lanes = torch.nonzero(live).flatten()[:pick].tolist()

    def one(k):
        sl = lambda x: x[k:k + 1].contiguous() if isinstance(x, torch.Tensor) else x
        args = (Vec3(*map(sl, o)), Vec3(*map(sl, d)), *map(sl, rest))
        return lambda: fn(coffee64, *args)

    counts = {k: one(k)()[-1].tolist() for k in lanes}
    longest = sorted(lanes, key=lambda k: -counts[k][0])[:keep]
    rows = [(timed(one(k), 5)[1], counts[k][0], counts[k][2]) for k in longest]
    ms, nodes, tests = (np.asarray(x, np.float64) for x in zip(*rows))
    a, b, c = np.linalg.lstsq(np.stack([np.ones_like(ms), nodes, tests], 1), ms, rcond=None)[0]
    return (f"float64 {name} lone walks ({keep} longest of {len(lanes)} live lanes, B=1): "
            f"{b * 1e3:.4f} us a node visit, {c * 1e3:.4f} us a test, {a:.4f} ms a launch; "
            f"longest {ms.max():.3f} ms over {int(nodes[ms.argmax()])} nodes, "
            f"{int(tests[ms.argmax()])} tests")


out.append(lone_walks("closest_bvh", closest_calls[18]))
out.append(lone_walks("any_bvh", any_calls[1]))
del closest_calls, any_calls
with torch.cuda.device(dev):
    out.append("float64 persistent grids: bvh64<false> "
               f"{lib.bpt_bvh_f64_blocks(0)}, bvh64<true> {lib.bpt_bvh_f64_blocks(1)} blocks "
               "of 128 threads")
"""

_TAIL = r"""
def sass_functions():  # {mangled name: its SASS instructions} of the library
    import re, shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(build.library_path())], capture_output=True,
                          text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            cur.append(re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", line).strip())
    return funcs


def sass_digests(funcs):  # sha256 of each float32 wave kernel's SASS
    if funcs is None:
        return "SASS: cuobjdump not found"
    out = []
    for label, tag in (("closest_bvh", "11closest_bvh"), ("any_bvh", "7any_bvh"),
                       ("pt_wave_bounce", "14pt_wave_bounceE")):
        for name, ins in funcs.items():
            if tag in name:
                out.append(f"{label} {hashlib.sha256(chr(10).join(ins).encode()).hexdigest()[:16]} "
                           f"({len(ins)} instructions)")
    return "SASS sha256 (float32): " + "; ".join(out)


def sass_bvh64(funcs):  # the float64 walks' instructions by kind
    if funcs is None:
        return "SASS: cuobjdump not found"
    out = []
    for name, ins in sorted(funcs.items()):
        if "5bvh64" not in name:
            continue
        ops = [(x.split()[1:] if x.startswith("@") else x.split()) or [""] for x in ins]
        ops = [o[0].split(".")[0] for o in ops]
        kinds = {k: sum(o == k for o in ops) for k in ("LDG", "STG", "DADD", "DMUL", "DFMA",
                                                       "DSETP", "MUFU", "BRA", "ATOMG")}
        out.append(f"{name}: {len(ins)} instructions, " + ", ".join(
            f"{k} {v}" for k, v in kinds.items()))
    return "SASS (float64): " + "; ".join(out)


funcs = sass_functions()
extra = ["ptxas: " + "; ".join(ptxas(e) for e in ("11closest_bvhE", "7any_bvhE",
                                                 "14pt_wave_bounce", "5bvh64")),
         sass_digests(funcs), sass_bvh64(funcs)]
for name in ("closest_bvh", "any_bvh"):
    query = {"closest_bvh": "bpt_wave_blocks", "any_bvh": "bpt_any_blocks"}[name]
    if hasattr(lib, query):
        with torch.cuda.device(dev):
            blocks = getattr(lib, query)()
        extra.append(f"{name}'s persistent grid: {blocks} blocks of 128 threads")
print("\n".join(out + extra))
"""


def main(argv=None) -> int:
    dirs = list(sys.argv[1:] if argv is None else argv)
    run = _HEAD + _F32 + _F64 + _TAIL
    if dirs and dirs[0] == "--f64-only":
        dirs, run = dirs[1:], _HEAD + _F64 + _TAIL
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
        path = os.path.abspath(d)
        proc = subprocess.run([sys.executable, "-c", run, data], cwd=path,
                              env=dict(os.environ, PYTHONPATH=path),
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(f"== {d} ({card})\n{proc.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
