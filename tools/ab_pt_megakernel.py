"""A/B of the PT and BDPT megakernels between copies of bpt_tpu_torch, on
one card.

Each argument is a directory holding a ``bpt_tpu_torch`` package (this
checkout, or another commit unpacked with ``git archive``).  In the order
given, each runs in its own process: it builds that copy's kernels, then
times ``pt_megakernel_pixels`` on the cornell box at 512x512 (one chunk of
2^18 pixels), 16 spp, depth 10, seed 0 (CUDA events, 10 calls after a
warm-up), ``pt_megakernel`` in RNG mode at B = 65,536 random rays, depth
10, and ``bdpt_megakernel_pixels`` (bdpt and bdpt-mis) at the PT pixels
shape, and prints each with rays_traced and the brute-force kernels'
ptxas registers and spills.  Give the copies as A B B A to see the spread.

    python tools/ab_pt_megakernel.py DIR_A DIR_B DIR_B DIR_A
"""

from __future__ import annotations

import os
import subprocess
import sys

_RUN = r"""
import dataclasses, sys
import numpy as np, torch
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

log = build.build().with_suffix(".log").read_text().splitlines()


def ptxas(entry):  # ptxas's stack / spill and register lines of one kernel
    k = next(k for k, l in enumerate(log) if "entry function" in l and entry in l)
    lines = [l.strip() for l in log[k + 1:k + 5] if "spill" in l or "Used" in l]
    return f"{entry}: " + " / ".join(lines)


regs = "; ".join(ptxas(e) for e in ("13pt_megakernelE", "15bdpt_megakernelE"))
dev = torch.device("cuda", 0)
scene = cornell_box(device=dev)
W, S, depth = 512, 4, 10
cfg = dataclasses.replace(cornell_box_camera(), image_width=W, samples_per_pixel=S * S)
cam = pk.camera_table(camera_constants(cfg, torch.float32, dev))
pix = torch.arange(W * W, dtype=torch.int64, device=dev)
i, j = (pix % W).float(), (pix // W).float()
g = np.random.default_rng(0)
B = 65536
o = Vec3(*torch.from_numpy(g.uniform(50, 500, (B, 3)).astype(np.float32)).to(dev).unbind(1))
d = Vec3(*torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev).unbind(1))
ids = torch.arange(B, dtype=torch.int32, device=dev)
runs = {
    "pixels 512x512x16spp": lambda: pk.pt_megakernel_pixels(
        scene, i, j, i * 0, j * 0, pix, cam, rng.prng_key(0), depth, spp_loop=S * S, sqrt_spp=S),
    "rays B=65536": lambda: pk.pt_megakernel(scene, o, d, ids, rng.prng_key(0), depth),
    "bdpt pixels 512x512x16spp": lambda: bk.bdpt_megakernel_pixels(
        scene, i, j, pix, cam, rng.prng_key(0), depth, S),
    "bdpt-mis pixels 512x512x16spp": lambda: bk.bdpt_megakernel_pixels(
        scene, i, j, pix, cam, rng.prng_key(0), depth, S, mis=True),
}
out = []
for name, fn in runs.items():
    res = fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        fn()
    stop.record()
    torch.cuda.synchronize()
    out.append(f"{name} {start.elapsed_time(stop) / 10:.3f} ms (rays {int(res[3])})")
print("; ".join(out) + f"; ptxas: {regs}")
"""


def main(argv=None) -> int:
    dirs = sys.argv[1:] if argv is None else argv
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", _RUN], cwd=os.path.abspath(d),
                              env=dict(os.environ, PYTHONPATH=os.path.abspath(d)),
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(f"{d}: {proc.stdout.strip()} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
