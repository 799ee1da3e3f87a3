"""Where bdpt-mis's excess over PT on the glass stand-in comes from, on a CPU.

    python tools/glass_mis_witness.py   # ~20 min

The north-star (tools/torch_northstar.py, 1920x1080, 1024 spp, depth 80)
renders bdpt-mis at about twice PT's linear radiance.  This tool holds
that ratio to a second witness and finds the paths that carry it.  Every
render is float32, seed 0, on the CPU; a ratio is the mean of the linear
radiance (framebuffer / spp) over the mean of PT's, over the whole image
and over its upper and lower halves of rows.

1. The glass stand-in at 64x36, 64 spp, depth 80, pt and bdpt-mis:
   ``bpt_tpu``'s own ``render()`` (its jnp stratum loop on a CPU) and the
   port's stratum loop (``render_part`` on route "strata", the same draws:
   it prints how many pixels differ from ``bpt_tpu``'s beyond rtol 1e-4).
   The card's route, the fused loop, draws other samples: its ratio at
   full size is tools/torch_northstar.py's.
2. The stand-in's floor and light alone (every other surface dropped), 32x18,
   16 spp: ``bpt_tpu``'s ``render()`` and the port's stratum loop at depths
   2, 3 and 80, with pt, bdpt and bdpt-mis, and the light's exact direct
   illumination of the floor at the same primary rays (a 128x128 midpoint
   quadrature over the light; the floor sees nothing else, so that is the
   whole image).
3. The same estimators with the vertices of a light subpath that land on
   an emitter after a bounce kept from connecting as emitters (the port's
   ``models.bdpt.connect_paths`` wrapped: ``is_light`` true on the light
   subpath's slot 0 only): bdpt-mis on the floor and light at depth 80 and
   on the glass stand-in at 64x36, 64 spp.

The last line is one JSON object of every figure.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SCENE = os.path.join(ROOT, "scenes", "glass", "glass_standin.yaml")
SEED = 0
GLASS_SIZE = (64, 36, 64)  # width, height, spp of the glass renders


def floor_and_light_yaml(out_dir: str) -> str:
    """The stand-in's YAML with only its Floor and Light surfaces, the
    floor's OBJ by absolute path; returns the new file's path."""
    keep = []
    for line in open(SCENE).read().splitlines():
        if "file:" in line and "floor.obj" not in line:
            continue
        keep.append(line.replace('"data/floor.obj"',
                                 json.dumps(os.path.join(os.path.dirname(SCENE), "data",
                                                         "floor.obj"))))
    path = os.path.join(out_dir, "floor_and_light.yaml")
    with open(path, "w") as f:
        f.write("\n".join(keep) + "\n")
    return path


def ratios(fb: np.ndarray, pt: np.ndarray) -> dict:
    h = fb.shape[0] // 2
    return {"all": float(fb.mean() / pt.mean()),
            "upper": float(fb[:h].mean() / pt[:h].mean()) if pt[:h].mean() > 0 else None,
            "lower": float(fb[h:].mean() / pt[h:].mean())}


def jax_render(path, W, H, spp, depth, integ):
    """Linear radiance [H, W, 3] of bpt_tpu's render() on the CPU."""
    import jax.numpy as jnp

    from bpt_tpu.models.render import render
    from bpt_tpu.scene.loader import load_scene_from_yaml

    ls = load_scene_from_yaml(path, dtype=jnp.float32, verbose=False)
    cfg = dataclasses.replace(ls.camera, image_width=W, aspect_ratio=W / H,
                              samples_per_pixel=spp, max_depth=depth, integrator=integ)
    r = render(ls.scene, cfg, seed=SEED)
    return np.asarray(r.framebuffer_sum, np.float64) / r.samples_per_pixel


def port_render(path, W, H, spp, depth, integ):
    """Linear radiance [H, W, 3] of the port's stratum loop (render_part on
    route "strata")."""
    import torch

    from bpt_tpu_torch.models import render as mr
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml

    ls = load_scene_from_yaml(path, dtype=torch.float32, device="cpu", verbose=False)
    cfg = dataclasses.replace(ls.camera, image_width=W, aspect_ratio=W / H,
                              samples_per_pixel=spp, max_depth=depth, integrator=integ)
    fb, _ = mr.render_part(ls.scene, cfg, SEED, integ, "strata", 0, W * H)
    return fb.numpy().astype(np.float64).reshape(H, W, 3) / cfg.effective_spp


def direct_light(path, W, H, spp, n=128):
    """The floor's direct illumination by the light at the stratum loop's
    primary rays, averaged a pixel: L = albedo / pi * Le * sum over the
    light's n x n cells of cos * cos' / r^2 * dA (floor y = 0, a
    horizontal light facing down)."""
    import torch
    import yaml

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models import render as mr
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml

    doc = yaml.safe_load(open(path))
    light = np.asarray(next(s for s in doc["surfaces"] if s.get("material") == "Light")
                       ["vertices"], np.float64)
    le = np.asarray(doc["materials"]["Light"]["emission"], np.float64)
    albedo = np.asarray(doc["materials"]["Floor"]["color"], np.float64) / 255.0
    floor = np.asarray([[float(x) for x in ln.split()[1:]]
                        for ln in open(os.path.join(os.path.dirname(SCENE), "data", "floor.obj"))
                        if ln.startswith("v ")])
    assert np.ptp(light[:, 1]) == 0 and np.ptp(floor[:, 1]) == 0 and floor[0, 1] == 0
    ls = load_scene_from_yaml(path, dtype=torch.float64, device="cpu", verbose=False)
    cfg = dataclasses.replace(ls.camera, image_width=W, aspect_ratio=W / H,
                              samples_per_pixel=spp)
    cc = camera_constants(cfg, torch.float64)
    S = cfg.sqrt_spp ** 2
    pix = torch.arange(W * H, dtype=torch.int64).repeat(S)
    s = torch.arange(S, dtype=torch.int64).repeat_interleave(W * H)
    o, d, _ = mr.jnp_raygen(cc, pix, s, rng.prng_key(SEED), torch.float64)
    o, d = o.numpy(), d.numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -o[:, 1] / d[:, 1]
    x = o + t[:, None] * d
    hit = ((t > 0) & (x[:, 0] >= floor[:, 0].min()) & (x[:, 0] <= floor[:, 0].max())
           & (x[:, 2] >= floor[:, 2].min()) & (x[:, 2] <= floor[:, 2].max()))
    h = light[0, 1]
    (x0, x1), (z0, z1) = (light[:, 0].min(), light[:, 0].max()), (light[:, 2].min(),
                                                                  light[:, 2].max())
    gx = x0 + (np.arange(n) + 0.5) / n * (x1 - x0)
    gz = z0 + (np.arange(n) + 0.5) / n * (z1 - z0)
    lx, lz = (a.ravel() for a in np.meshgrid(gx, gz))
    dA = (x1 - x0) * (z1 - z0) / (n * n)
    E = np.zeros(len(x))
    for a in range(0, len(x), 1024):
        dx = lx[None] - x[a:a + 1024, 0:1]
        dz = lz[None] - x[a:a + 1024, 2:3]
        r2 = dx * dx + dz * dz + h * h
        E[a:a + 1024] = (h * h / (r2 * r2)).sum(1) * dA
    rad = np.where(hit, E, 0.0)[:, None] * (albedo / np.pi * le)[None]
    return rad.reshape(S, H, W, 3).mean(0)


def emitter_slot0_only():
    """Wraps the port's ``connect_paths`` so that only the light subpath's
    slot 0 (the emitter sample) connects as an emitter."""
    import torch

    from bpt_tpu_torch.models import bdpt as tb

    orig = tb.connect_paths

    def connect_paths(scene, cam, light, *a, **k):
        slot = torch.arange(light.valid.shape[0], device=light.valid.device)[:, None]
        return orig(scene, cam, light._replace(is_light=light.is_light & (slot == 0)), *a, **k)

    tb.connect_paths = connect_paths
    return lambda: setattr(tb, "connect_paths", orig)


def timed(label, fn, *a):
    t0 = time.monotonic()
    out = fn(*a)
    print(f"{label}: {time.monotonic() - t0:.1f} s, mean {out.mean():.7g}", flush=True)
    return out


def main() -> int:
    W, H, spp = GLASS_SIZE

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    out = {"glass": {"size": [W, H], "spp": spp, "depth": 80}, "floor_and_light": {}}

    # 1. the glass stand-in: bpt_tpu and the port's stratum loop
    g = out["glass"]
    imgs = {}
    for integ in ("pt", "bdpt-mis"):
        imgs["bpt_tpu", integ] = timed(f"glass bpt_tpu {integ}", jax_render, SCENE, W, H,
                                       spp, 80, integ)
        imgs["strata", integ] = timed(f"glass port strata {integ}", port_render, SCENE, W, H,
                                      spp, 80, integ)
    for src in ("bpt_tpu", "strata"):
        g[src] = {"mean_linear_pt": float(imgs[src, "pt"].mean()),
                  "mean_linear_bdpt_mis": float(imgs[src, "bdpt-mis"].mean()),
                  "bdpt_mis_over_pt": ratios(imgs[src, "bdpt-mis"], imgs[src, "pt"])}
    for integ in ("pt", "bdpt-mis"):
        a, b = imgs["bpt_tpu", integ], imgs["strata", integ]
        g[f"strata_pixels_differing_{integ}"] = int(
            (~np.isclose(b, a, rtol=1e-4, atol=1e-6).all(-1)).sum())
    g["pixels"] = W * H

    # 2. the floor and light alone, and its exact direct light
    with tempfile.TemporaryDirectory() as tmp:
        fl = floor_and_light_yaml(tmp)
        f = out["floor_and_light"]
        exact = timed("floor and light, direct light", direct_light, fl, 32, 18, 16)
        f["direct_light_mean"] = float(exact.mean())
        for depth in (2, 3, 80):
            row = f[f"depth_{depth}"] = {}
            for src in ("bpt_tpu", "strata"):
                fbs = {}
                for integ in ("pt", "bdpt", "bdpt-mis"):
                    fn = ((lambda i: jax_render(fl, 32, 18, 16, depth, i)) if src == "bpt_tpu"
                          else (lambda i: port_render(fl, 32, 18, 16, depth, i)))
                    fbs[integ] = timed(f"floor d{depth} {src} {integ}", fn, integ)
                row[src] = {i: float(v.mean()) for i, v in fbs.items()}
                row[src]["pt_over_direct_light"] = float(fbs["pt"].mean() / exact.mean())
                row[src]["bdpt_over_pt"] = ratios(fbs["bdpt"], fbs["pt"])["all"]
                row[src]["bdpt_mis_over_pt"] = ratios(fbs["bdpt-mis"], fbs["pt"])["all"]

        # 3. light subpath vertices on an emitter kept from connecting as one
        restore = emitter_slot0_only()
        try:
            mis = timed("floor d80 strata bdpt-mis, emitter slot 0 only", port_render, fl,
                        32, 18, 16, 80, "bdpt-mis")
            f["emitter_slot0_only"] = {
                "bdpt_mis": float(mis.mean()),
                "bdpt_mis_over_direct_light": float(mis.mean() / exact.mean())}
            glass = timed("glass strata bdpt-mis, emitter slot 0 only", port_render, SCENE,
                          W, H, spp, 80, "bdpt-mis")
            g["emitter_slot0_only"] = {
                "mean_linear_bdpt_mis": float(glass.mean()),
                "bdpt_mis_over_pt": ratios(glass, imgs["strata", "pt"])}
        finally:
            restore()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
