"""A/B of the clustered hit kernels ``clustered_closest`` / ``clustered_any``
(csrc/cluster_wave.cu) and ``plucker_closest`` / ``plucker_any``
(csrc/plucker.cu) between copies of bpt_tpu_torch, on one card.

Each argument is a directory holding a ``bpt_tpu_torch`` package and its
``chip_smoke.py`` (this checkout, or another commit unpacked with ``git
archive``).  The copies' kernels are built first, all at once; then, in the
order given, each copy runs in its own process on the coffee stand-in
(this checkout's ``scenes/coffee`` and ``chip_smoke.py``'s scene and lane
helpers, the copy's package), seed 0, timing with CUDA events (mean of 5
calls after a warm-up):

- under ``BPT_TPU_NO_FTB=1`` (the rolled kernels) and under
  ``BPT_TPU_WAVE_IMPL=plucker`` (the Plücker kernels): each of the 19
  closest and 10 any launches of one coffee bdpt-mis 512x512 / 4 spp /
  depth 10 render (camera bounce 1 is closest launch 1, the shadow wave of
  camera vertex 1 any launch 1), on its own recorded inputs, with its live
  lanes, bound (``chip_smoke.cluster_bound``; for ``plucker_closest`` and
  ``plucker_any`` the slab tests and tables they need,
  ``chip_smoke.plucker_closest_needs`` and ``plucker_any_needs``, the
  latter over the plain traversal's first hits, in every copy), the share
  of the bound's FP32 operations in slab tests and cluster features,
  counters and a sha256 of its outputs and counters; their sums; the
  render's wall (median of 3 after a warm-up), peak device memory over
  those 3 and framebuffer sha256;
- for the first copy only, the mean number of a warp's 32 lanes that enter
  a cluster the warp tests, on camera bounce 1 and the last closest
  launch, and on any launch 1 and the last any launch: the plain version
  run on 64 warps from the middle of the launch's live lanes, its
  ``Lanes.accept`` calls read per warp;
- 1,048,576 random rays in the scene's bounds with per-lane intervals (as
  chip_smoke.py phase 20: tmin from [0, 0.1] on half the lanes and T_MIN
  on the rest, tmax = inf on every 7th lane, every 8th lane dead) through
  each of the four kernels;
- ``chip_smoke.cluster_edge_lanes``' edge cases through each kernel
  (sha256 only);
- ptxas's registers and spills of the four clustered hit kernels, the
  blocks of a closest and of an any launch (the copy's grid queries; a
  copy without one launches a thread a lane, and its line says so), and a
  sha256 of the
  SASS (cuobjdump) of the clustered hit kernels (``cluster_closest``,
  ``cluster_any``, or an earlier copy's ``cluster_hit``) and of
  ``closest_bvh``, ``any_bvh`` and ``pt_wave_bounce``.

Equal hashes across copies mean bitwise equal outputs and counters.  Give
the copies as A B B A to see the spread:

    mkdir -p build/ab/parent && git archive <commit> bpt_tpu_torch chip_smoke.py \\
        | tar -x -C build/ab/parent
    python tools/ab_cluster_kernels.py build/ab/parent . . build/ab/parent
"""

from __future__ import annotations

import os
import subprocess
import sys

_BUILD = "from bpt_tpu_torch.ops.kernels import build; build.build()"

_RUN = r"""
import hashlib, importlib.util, os, re, shutil, statistics, subprocess, sys
import numpy as np, torch

DATA, FIRST = sys.argv[1], sys.argv[2] == "1"
spec = importlib.util.spec_from_file_location("smoke_here", os.path.join(DATA, "chip_smoke.py"))
here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(here)
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops.clusters import cluster_tables
from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels import cluster_wave as cw
from bpt_tpu_torch.ops.kernels import plucker as kp
from bpt_tpu_torch.ops.plucker import plucker_tables

log = build.build().with_suffix(".log").read_text().splitlines()
dev = torch.device("cuda", 0)
os.chdir(DATA)
coffee = here.coffee_builder().build(device=dev)
tab_bytes = {k: sum(t.numel() * t.element_size() for t in tab[:2])
             for k, tab in (("clustered", cluster_tables(coffee)),
                            ("plucker", plucker_tables(coffee)))}
out = []


def timed(fn, reps=5):
    res = fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(stop) / reps


def digest(res):
    h = hashlib.sha256()
    for x in res:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def recording(mod, name):
    fn, calls = getattr(mod, name), []

    def spy(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)

    spy.__dict__.update(fn.__dict__)
    setattr(mod, name, spy)
    return fn, calls


def renders(cfg):
    render(coffee, cfg, seed=0)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    rs = [render(coffee, cfg, seed=0) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev)
    fb = hashlib.sha256(np.ascontiguousarray(rs[0].framebuffer_sum).tobytes()).hexdigest()[:16]
    same = all(np.array_equal(r.framebuffer_sum, rs[0].framebuffer_sum) for r in rs[1:])
    walls = [r.stats.wall_seconds for r in rs]
    st = rs[0].stats
    return (f"wall median {statistics.median(walls):.6f} s {[round(w, 6) for w in walls]}, "
            f"rays {st.rays_traced}, shadow {st.shadow_rays}, peak device memory "
            f"{peak / 2**30:.3f} GiB, framebuffer sha256 {fb}"
            + ("" if same else " (renders differ)"))


def slab_share(name, c, slabs):
    slab = slabs * here.SLAB_OPS + (c[1] * 21 if name.startswith("plucker") else 0)
    tri = c[2] * (here.PLUCKER_OPS if name.startswith("plucker") else here.MT_OPS)
    return slab / max(1, slab + tri)


def entering(name, plain, args, W=64):
    # the plain version on W warps from the middle of the launch's live
    # lanes: per (warp, cluster) the lanes that enter it (m) and the
    # cluster's slots (n)
    scene, o, d, tmin, tmax = args
    live = int((tmax > 0).sum())
    start = max(0, (live // 2 - 16 * W) // 32 * 32)
    sl = slice(start, start + 32 * W)
    sub = (scene, Vec3(*(x[sl] for x in o)), Vec3(*(x[sl] for x in d)), tmin[sl], tmax[sl])
    accept, rec = cw.Lanes.accept, []

    def spy(self, L, valid, t, u, v, ids):
        rec.append((L // 32, ids.numel()))
        return accept(self, L, valid, t, u, v, ids)

    cw.Lanes.accept = spy
    try:
        res = plain(*sub)
    finally:
        cw.Lanes.accept = accept
    ms, ns = [], []
    for w, n in rec:
        m = torch.bincount(w, minlength=W)
        m = m[m > 0]
        ms.append(m)
        ns.append(torch.full_like(m, n))
    m, n = torch.cat(ms).double(), torch.cat(ns).double()
    return (f"{m.numel()} (warp, cluster) pairs on lanes [{start}, {start + 32 * W}) "
            f"({int((sub[4] > 0).sum())} live): {float(m.mean()):.3f} of 32 lanes enter "
            f"on average, 1 lane in {float((m == 1).double().mean()) * 100:.1f}%, more "
            f"lanes than slots in {float((m > n).double().mean()) * 100:.1f}%; slot steps "
            f"lane-serial {int(n.sum())}, ray steps warp-wide {int(m.sum())}; counters "
            f"{res[-1].tolist()}")


for impl, var, val, mod, names in (
        ("rolled", "BPT_TPU_NO_FTB", "1", cw, ("clustered_closest", "clustered_any")),
        ("plucker", "BPT_TPU_WAVE_IMPL", "plucker", kp, ("plucker_closest", "plucker_any"))):
    os.environ[var] = val
    cfg = here.coffee_camera(spp=4, integrator="bdpt-mis")
    render(coffee, cfg, seed=0)
    fc, closest_calls = recording(mod, names[0])
    fa, any_calls = recording(mod, names[1])
    render(coffee, cfg, seed=0)
    setattr(mod, names[0], fc)
    setattr(mod, names[1], fa)
    out.append(f"{impl}: coffee bdpt-mis 512x512x4spp d10 render with {var}={val}: "
               f"{renders(cfg)}")
    del os.environ[var]
    tab = tab_bytes["plucker" if impl == "plucker" else "clustered"]
    for name, fn, calls in ((names[0], fc, closest_calls), (names[1], fa, any_calls)):
        total, bound_total, lines = 0.0, 0.0, []
        for n, args in enumerate(calls):
            res, ms = timed(lambda: fn(*args))
            c = res[-1].tolist()
            live = int((args[4] > 0).sum())
            aabb = plucker_tables(coffee).aabb
            if name == "plucker_closest":
                slabs, tb = here.plucker_closest_needs(aabb, args[1], args[2], args[4], res[0])
            elif name == "plucker_any":  # the lanes' first hits from the plain traversal
                slabs, tb = here.plucker_any_needs(aabb, args[1], args[2], args[4],
                                                   kp._plucker(*args, any_hit=True).tri)
            else:
                slabs, tb = c[0], tab
            b = here.cluster_bound(name, c, args[4].numel(), live, tb, slabs)[0]
            total += ms
            bound_total += b
            lines.append(f"  {name} launch {n}: B={args[4].numel()} live {live}: {ms:.3f} ms, "
                         f"bound {b:.4f} ms, slab share {slab_share(name, c, slabs) * 100:.1f}%, "
                         f"slab tests needed {slabs}, counters {c}, sha256 {digest(res)}")
        out.append(f"{name}, the render's {len(calls)} launches: sum {total:.3f} ms, bound "
                   f"{bound_total:.4f} ms")
        out += lines
    if FIRST:
        for name, calls in ((names[0], closest_calls), (names[1], any_calls)):
            plain = getattr(mod, name + "_plain")
            for n in (1, len(calls) - 1):
                out.append(f"{name} launch {n}, lanes entering a cluster a warp tests: "
                           f"{entering(name, plain, calls[n])}")
    query = {"clustered_closest": "bpt_clustered_blocks", "plucker_closest": "bpt_plucker_blocks",
             "clustered_any": "bpt_clustered_any_blocks", "plucker_any": "bpt_plucker_any_blocks"}
    lib = build.load_library()
    for name in names:
        blocks = (f"{getattr(lib, query[name])()} blocks of 128 threads (its grid query)"
                  if hasattr(lib, query[name]) else
                  "no grid query: a thread a lane, ceil(B / 128) blocks")
        out.append(f"{name}'s launch: {blocks}")
    del closest_calls, any_calls

# random rays in the scene's bounds, per-lane intervals (chip_smoke.py phase 20's)
g = np.random.default_rng(0)
B = 1 << 20
lo, hi = (x.cpu().numpy() for x in (coffee.bvh_min[0], coffee.bvh_max[0]))
o_r = Vec3(*torch.from_numpy(g.uniform(lo, hi, (B, 3)).astype(np.float32)).to(dev).unbind(1))
d_r = Vec3(*torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev).unbind(1))
tmin_r = np.where(g.uniform(size=B) < 0.5, g.uniform(0.0, 0.1, B), T_MIN).astype(np.float32)
tmax_r = (tmin_r + g.uniform(0.0, float(np.linalg.norm(hi - lo)), B)).astype(np.float32)
tmax_r[::7] = np.inf
tmax_r[::8] = 0.0
rand = (coffee, o_r, d_r, torch.from_numpy(tmin_r).to(dev), torch.from_numpy(tmax_r).to(dev))
kernels = (("clustered_closest", cw.clustered_closest), ("clustered_any", cw.clustered_any),
           ("plucker_closest", kp.plucker_closest), ("plucker_any", kp.plucker_any))
for name, fn in kernels:
    res, ms = timed(lambda: fn(*rand), 3)
    out.append(f"{name}, {B} random rays in the scene's bounds: {ms:.3f} ms, counters "
               f"{res[-1].tolist()}, sha256 {digest(res)}")
del rand, o_r, d_r

cases = here.cluster_edge_lanes(coffee, here.dup_scene(dev))
for name, fn in kernels:
    out.append(f"{name} edge cases: " + "; ".join(
        f"{case} {digest(fn(*args))}" for case, args in cases.items()))


def sass_functions():  # {mangled name: its SASS instructions} of the library
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


funcs = sass_functions()
if funcs is None:
    out.append("SASS: cuobjdump not found")
else:
    labels = []
    for name, ins in sorted(funcs.items()):
        for tag in ("11cluster_hit", "11cluster_any", "15cluster_closest", "11closest_bvh",
                    "7any_bvh", "14pt_wave_bounceE"):
            if tag in name:
                sha = hashlib.sha256(chr(10).join(ins).encode()).hexdigest()[:16]
                labels.append(f"{name} {sha} ({len(ins)} instructions)")
    out.append("SASS sha256: " + "; ".join(labels))
out.append("ptxas: " + "; ".join(f"{k}: {v['registers']} registers, spill bytes "
                                 f"{v['spill_bytes']}"
                                 for k, v in sorted(here.cluster_ptxas(log).items())))
print("\n".join(out))
"""


def main(argv=None) -> int:
    dirs = list(sys.argv[1:] if argv is None else argv)
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
    for k, d in enumerate(dirs):
        path = os.path.abspath(d)
        proc = subprocess.run([sys.executable, "-c", _RUN, data, "1" if k == 0 else "0"],
                              cwd=path, env=dict(os.environ, PYTHONPATH=path),
                              capture_output=True, text=True)
        if proc.returncode:
            print(f"== {d} ({card}): failed\n{proc.stdout}{proc.stderr}", file=sys.stderr)
            return proc.returncode
        print(f"== {d} ({card})\n{proc.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
