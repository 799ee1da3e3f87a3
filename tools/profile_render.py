"""Where the time of a bpt_tpu_torch render goes, on one NVIDIA card.

Renders the cornell box or the coffee stand-in (scenes/coffee/
coffee_standin.yaml, 91,540 triangles: PT through pt_wave, BDPT through
the jnp-stream wave loop over closest_bvh / any_bvh) with PT, BDPT or
BDPT-MIS — default PT at 512x512, 16 spp, depth 10, seed 0; ``--ref-vis``
(BDPT's shadow-endpoint emulation) and ``--defocus`` (angle 1, focused at
the cornell room's centre) send a small scene through the stratum loop:
one warm-up render, then ``--renders`` timed ones (their walls and
median), then one render under ``torch.profiler`` with CUDA activity.
Prints the profiler's tables by device time and by host time, the device
time of the megakernels and the wave kernel, of closest_bvh, any_bvh,
closest_tri and any_tri, of the clustered and Plücker hit kernels (under
bpt_tpu's switches BPT_TPU_NO_FTB=1 / BPT_TPU_WAVE_IMPL=plucker, read from
the environment), of the sorts, the gathers and everything else
(raygen, sort keys, the BDPT wavefront's torch ops), the sum of all
device time, and the device time spent before
the wall clock stops as a share of the profiled render's wall (the
device's busy share; the profiler's own host overhead lengthens that
wall).  The coffee scene needs PyYAML.

    python tools/profile_render.py [--scene cornell|coffee]
        [--integrator pt|bdpt|bdpt-mis] [--width 512] [--spp 16]
        [--depth 10] [--renders 10] [--ref-vis] [--defocus]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", choices=("cornell", "coffee"), default="cornell")
    ap.add_argument("--integrator", choices=("pt", "bdpt", "bdpt-mis"), default="pt")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--renders", type=int, default=10)
    ap.add_argument("--ref-vis", action="store_true")
    ap.add_argument("--defocus", action="store_true")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bpt_tpu_torch.models.render import render
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

    if not torch.cuda.is_available():
        print("profile_render: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    dtype = torch.float64 if args.f64 else torch.float32
    if args.scene == "coffee":
        from bpt_tpu_torch.scene.loader import load_scene_from_yaml

        loaded = load_scene_from_yaml(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", "scenes", "coffee",
            "coffee_standin.yaml"), device=dev, dtype=dtype)
        scene, cam = loaded.scene, loaded.camera
    else:
        scene, cam = cornell_box(device=dev, dtype=dtype), cornell_box_camera()
    cfg = dataclasses.replace(cam, image_width=args.width, aspect_ratio=1.0,
                              samples_per_pixel=args.spp, max_depth=args.depth,
                              integrator=args.integrator, ref_vis=args.ref_vis)
    if args.defocus:
        cfg = dataclasses.replace(cfg, defocus_angle=1.0,
                                  focus_dist=math.dist(cam.lookfrom, (277.5, 277.5, 277.5)))
    render(scene, cfg, seed=0)  # warm-up: kernel build and load
    walls = [render(scene, cfg, seed=0).stats.wall_seconds
             for _ in range(args.renders)]
    switches = " ".join(f"{k}={os.environ[k]}" for k in ("BPT_TPU_NO_FTB", "BPT_TPU_WAVE_IMPL")
                        if k in os.environ)
    print(f"{args.scene} {dtype} {args.integrator} ref_vis={args.ref_vis} "
          f"defocus={args.defocus} "
          f"{switches or 'no switch'} "
          f"{args.width}x{args.width} {args.spp} spp render walls {walls} s, median "
          f"{statistics.median(walls)} s ({card})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = render(scene, cfg, seed=0)
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    # device_time fields are in microseconds.  Only the device's own
    # events count: a host op (aten::index) also reports the time of the
    # kernels it launched.  render() reads its results back (the only
    # device-to-host copies) after it stops the wall clock
    events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    readback = sum(e.self_device_time_total for e in events
                   if e.key.startswith("Memcpy DtoH")) / 1e3
    groups = {"kernel": ("megakernel", "pt_wave_bounce"),
              "closest_bvh": ("closest_bvh", "bvh64<false"),
              "any_bvh": ("any_bvh", "bvh64<true"), "closest_tri": ("closest_tri",),
              "any_tri": ("any_tri",), "clustered_hit": ("RolledMT",),
              "plucker_hit": ("PluckerChop",), "sort": ("Radix", "radix", "sort"),
              "gather": ("index", "gather")}
    dev_ms = {name: 0.0 for name in (*groups, "other")}
    calls = {name: 0 for name in dev_ms}
    for e in events:
        if e.self_device_time_total <= 0 or e.key.startswith("Memcpy DtoH"):
            continue
        name = next((n for n, keys in groups.items() if any(k in e.key for k in keys)),
                    "other")
        dev_ms[name] += e.self_device_time_total / 1e3
        calls[name] += e.count
    wall = res.stats.wall_seconds * 1e3
    inside = busy - readback
    shares = ", ".join(f"{n} {v:.3f} ms ({v / inside * 100:.1f}%)" for n, v in dev_ms.items())
    print(f"profiled render wall {wall:.3f} ms; device time before the read-back "
          f"{inside:.3f} ms: {shares}; {readback:.3f} ms read-back after the wall; "
          f"device busy {inside / wall * 100:.1f}% of the wall; rays_traced "
          f"{res.stats.rays_traced} ({card})")
    walks = dev_ms["closest_bvh"] + dev_ms["any_bvh"]
    print(f"the BVH walks: closest_bvh {calls['closest_bvh']} launches {dev_ms['closest_bvh']:.3f} "
          f"ms, any_bvh {calls['any_bvh']} launches {dev_ms['any_bvh']:.3f} ms; together "
          f"{walks:.3f} ms, {walks / wall * 100:.1f}% of the profiled wall, "
          f"{walks / (statistics.median(walls) * 1e3) * 100:.1f}% of the median wall ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
