"""Where the time of a bpt_tpu_torch render goes, on one NVIDIA card.

Renders the cornell box with PT, BDPT or BDPT-MIS (default PT at 512x512,
16 spp, depth 10, seed 0): one warm-up render, then ``--renders`` timed ones (their walls
and median), then one render under ``torch.profiler`` with CUDA activity.
Prints the profiler's tables by device time and by host time, the
kernel's device time, the sum of all device time, and the device time
spent before the wall clock stops as a share of the profiled render's
wall (the device's busy share; the profiler's own host overhead
lengthens that wall).

    python tools/profile_render.py [--integrator pt|bdpt|bdpt-mis]
        [--width 512] [--spp 16] [--depth 10] [--renders 10]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--integrator", choices=("pt", "bdpt", "bdpt-mis"), default="pt")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--renders", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bpt_tpu_torch.models.render import render
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

    if not torch.cuda.is_available():
        print("profile_render: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    scene = cornell_box(device=torch.device("cuda", 0))
    cfg = dataclasses.replace(cornell_box_camera(), image_width=args.width,
                              samples_per_pixel=args.spp, max_depth=args.depth,
                              integrator=args.integrator)
    render(scene, cfg, seed=0)  # warm-up: kernel build and load
    walls = [render(scene, cfg, seed=0).stats.wall_seconds
             for _ in range(args.renders)]
    print(f"{args.integrator} render walls {walls} s, median "
          f"{statistics.median(walls)} s ({card})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = render(scene, cfg, seed=0)
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    # device_time fields are in microseconds.  render() reads its results
    # back (the only device-to-host copies) after it stops the wall clock
    busy = sum(e.self_device_time_total for e in events) / 1e3
    readback = sum(e.self_device_time_total for e in events
                   if e.key.startswith("Memcpy DtoH")) / 1e3
    kernel = sum(e.self_device_time_total for e in events
                 if "megakernel" in e.key) / 1e3
    wall = res.stats.wall_seconds * 1e3
    inside = busy - readback
    print(f"profiled render wall {wall:.3f} ms; kernel {kernel:.3f} ms; "
          f"device time {busy:.3f} ms, of it {readback:.3f} ms read-back after "
          f"the wall; device busy {inside / wall * 100:.1f}% of the wall "
          f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
