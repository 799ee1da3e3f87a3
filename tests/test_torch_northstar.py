"""The north-star's tool and the goldens the port had not held, on a CPU,
through the port alone (no JAX render; the Pallas comparisons of the
north-star's lanes are in test_torch_northstar_ids.py).

- ``tools/gen_goldens.py``'s smoke_pt (48x48, 9 spp, depth 5, the two
  volume boxes of gen_goldens.py:49-69, built with the port's
  ``SceneBuilder.add_volume_box``) and earth_pt (48x48, 9 spp, depth 4,
  scenes/earth.yaml), seed 1234, float32: ``bpt_tpu``'s jnp stratum loop
  on a CPU, reproduced by the port's ``_render_strata`` on a CPU (``render()``
  on a CPU scene takes the card's routes: ROADMAP §3).
- ``tools/torch_northstar.py``: the k x k area map and the 8x8-downsampled
  RMSE on seeded synthetic images, a CPU run at a tiny size in its own
  process (one JSON line last, no JAX imported), its images equal to
  ``render()``'s, exit 2 without a card.
- chip_smoke.py phase 27's launch plan of one stratum range and its plain
  BDPT version with a stratum a lane.
"""

import dataclasses
import json
import os
import subprocess
import sys

import chip_smoke
import numpy as np
import pytest
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.models import camera as tcam
from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.ops.kernels import bdpt_kernel as tbk
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.scene.loader import load_scene_from_yaml as tload
from bpt_tpu_torch.utils.png import read_png
from torch_parity import smoke_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_northstar as ns  # noqa: E402
from torch_northstar_glass import downsampled_rmse  # noqa: E402

GLASS = os.path.join(ROOT, "scenes", "glass", "glass_standin.yaml")
SMALL = ["--device", "cpu", "--size", "24x24", "--spp", "1", "--depth", "2"]


def _rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float64) / 255 - b.astype(np.float64) / 255) ** 2)))


def _golden_scene(name):
    if name == "smoke_pt":
        return (smoke_scene(tbuilder, device="cpu", dtype=torch.float32),
                tpresets.cornell_box_camera())
    loaded = tload(os.path.join(ROOT, "scenes", "earth.yaml"), dtype=torch.float32, device="cpu",
                   verbose=False)
    return loaded.scene, loaded.camera


@pytest.mark.parametrize("name, depth", [("smoke_pt", 5), ("earth_pt", 4)])
def test_golden_through_the_loop(name, depth):
    """gen_goldens.py's smoke and earth configs through the port's stratum
    loop on a CPU, without a JAX render.  earth_pt reproduces its golden
    exactly (RMSE 0).  smoke_pt: RMSE 0.004035, every pixel exact but (7,
    37), where one of nine samples reaches the light at its fifth bounce in
    the port (1.9177878 in each channel) and not in the golden.
    ``bpt_tpu``'s own estimator run op by op (``jax.disable_jit``) gives the
    port's 1.9177878; jitted, XLA fuses it (contracting a*b+c) and gives 0
    (tools/smoke_golden_pixel.py).  That one pixel is over the cornell PT
    golden's 0.004 by itself, so smoke is held to that pixel alone."""
    scene, cam = _golden_scene(name)
    cfg = dataclasses.replace(cam, image_width=48, aspect_ratio=1.0, samples_per_pixel=9,
                              max_depth=depth, integrator="pt")
    cc = tcam.camera_constants(cfg, torch.float32)
    fb = torch.zeros((48 * 48, 3))
    rays = trender._render_strata(scene, cfg, cc, "pt", 1234, fb, None, None, None)[0]
    img = trender.RenderResult(fb.numpy().reshape(48, 48, 3), 9, None, 48, 48).rgb8()
    golden = read_png(os.path.join(ROOT, "tests", "golden", f"{name}.png"))
    assert img.shape == golden.shape and img.any() and int(rays) > 0
    differ = {tuple(p) for p in np.argwhere((img != golden).any(-1))}
    if name == "earth_pt":
        assert _rmse(img, golden) == 0.0
    else:
        assert differ == {(7, 37)}
        assert _rmse(img, golden) == pytest.approx(0.004035, abs=5e-7)


@pytest.mark.parametrize("area", [1, 3])
def test_area_map_and_downsampled_rmse(area):
    """The golden's pixel is the area mean of area x area pixels; the RMSE
    is over 8x8 block means in [0, 1], as torch_northstar_glass.py's."""
    g = np.random.default_rng(20 + area)
    ref = g.integers(0, 250, size=(48, 64, 3), dtype=np.uint8)
    big = np.repeat(np.repeat(ref, area, axis=0), area, axis=1)
    # each area x area block of `big` is one value, its mean that value
    np.testing.assert_allclose(ns.block_means(big.astype(np.float64), area), ref, rtol=1e-15)
    assert ns.rmse_vs_ref(big, ref, area) < 1e-14
    # every pixel 5 levels brighter
    assert ns.rmse_vs_ref(big + 5, ref, area) == pytest.approx(5 / 255, rel=1e-12)
    # a block of 8x8 golden pixels averaged: one bright pixel moves it 1/64,
    # one block of the 6 x 8 x 3 values
    shifted = ref.copy()
    shifted[0, 0, 0] += 64
    assert ns.rmse_vs_ref(big, shifted, area) == pytest.approx(
        np.sqrt((64 / 255 / 64) ** 2 / 144), rel=1e-12)
    other = g.integers(0, 256, size=ref.shape, dtype=np.uint8)
    assert ns.rmse_vs_ref(other, ref, 1) == pytest.approx(downsampled_rmse(other, ref),
                                                          rel=1e-15)


def test_ref_area():
    """The golden's 640x360 scaled by a whole factor, and nothing else."""
    assert ns.ref_area(1920, 1080) == 3 and ns.ref_area(640, 360) == 1
    assert ns.ref_area(48, 48) == 0 and ns.ref_area(1920, 1000) == 0
    assert ns.ref_area(320, 180) == 0


def _last_line(text):
    line = text.strip().splitlines()[-1]
    return json.loads(line)


def test_cpu_run_prints_one_json_line_last_without_jax(tmp_path):
    """The tool at a tiny size on the CPU in its own process: routes fused,
    one line of figures an integrator, every figure in one JSON line last,
    no JAX or bpt_tpu imported."""
    code = ("import sys\nsys.path.insert(0, 'tools')\nfrom torch_northstar import main\n"
            "rc = main(sys.argv[1:])\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'bpt_tpu')]\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code, *SMALL, "--out-dir", str(tmp_path)],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "cpu" and len([ln for ln in lines if "route fused" in ln]) == 3
    assert [ln.split(":")[0] for ln in lines if "wall_s" in ln and not ln.startswith("{")] == [
        "pt", "bdpt", "bdpt-mis"]
    out = _last_line(proc.stdout)
    assert out["ok"] and set(out["northstar"]) == {"pt", "bdpt", "bdpt-mis"}
    assert out["size"] == [24, 24] and out["spp"] == 1 and out["depth"] == 2
    for name, m in out["northstar"].items():
        assert m["finite"] and m["rays_traced"] > 0 and m["peak_bytes"] == 0
        assert ("rmse_vs_pt" in m) == (name != "pt") and m.get("rmse_vs_ref") is None
        assert (m["shadow_rays"] > 0) == (name != "pt")
        assert set(m["launches"].values()) == {0}  # a wrapper counts launches on the card
    assert read_png(str(tmp_path / "northstar_bdpt.png")).shape == (24, 24, 3)


def test_cpu_images_are_render_s(tmp_path, capsys):
    """The tool's images and counters are ``render()``'s on the same CPU
    scene (which takes the fused route's plain versions), and its RMSE and
    ratio against PT those of the written images."""
    assert ns.main([*SMALL, "--out-dir", str(tmp_path)]) == 0
    out = _last_line(capsys.readouterr().out)["northstar"]
    loaded = tload(GLASS, dtype=torch.float32, device="cpu", verbose=False)
    for integ in ("pt", "bdpt-mis"):
        cfg = dataclasses.replace(loaded.camera, image_width=24, aspect_ratio=1.0,
                                  samples_per_pixel=1, max_depth=2, integrator=integ)
        r = trender.render(loaded.scene, cfg, seed=0)
        img = read_png(str(tmp_path / f"northstar_{integ}.png"))
        np.testing.assert_array_equal(img, r.rgb8())
        assert out[integ]["rays_traced"] == r.stats.rays_traced
        assert out[integ]["shadow_rays"] == r.stats.shadow_rays
        assert out[integ]["mean_linear"] == pytest.approx(
            float(r.framebuffer_sum.mean()) / r.samples_per_pixel, rel=1e-6)
    pt = read_png(str(tmp_path / "northstar_pt.png"))
    mis = read_png(str(tmp_path / "northstar_bdpt-mis.png"))
    assert out["bdpt-mis"]["rmse_vs_pt"] == pytest.approx(downsampled_rmse(mis, pt), rel=1e-12)
    assert out["bdpt-mis"]["mean_ratio_vs_pt"] == pytest.approx(mis.mean() / pt.mean(),
                                                                rel=1e-12)


def test_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ns.main(["--size", "48x48", "--spp", "1"]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_chip_smoke_strata_only_launches_one_range_and_restores_the_plan():
    """chip_smoke.py phase 27b's launch plan: one launch of strata [k0, k1)
    and one strata_sum from zeros, in both wrappers' modules, and the
    wrappers' own plan back afterwards."""
    calls = []
    rows = torch.from_numpy(np.random.default_rng(3).uniform(size=(3, 4, 5)).astype(np.float32))

    def launch(k0, nk, out):
        calls.append((k0, nk, tuple(out.shape)))
        out.copy_(rows)

    plans = tk.walk_launches, tbk.walk_launches
    with chip_smoke.strata_only(1020, 1024):
        assert tk.walk_launches is tbk.walk_launches is not plans[0]
        tot = tbk.walk_launches(5, True, 1024, launch, torch.device("cpu"))
    assert (tk.walk_launches, tbk.walk_launches) == plans
    assert calls == [(1020, 4, (3, 4, 5))]
    np.testing.assert_array_equal(tot.numpy(), ((rows[:, 0] + rows[:, 1]) + rows[:, 2]
                                                + rows[:, 3]).numpy())


def test_stratum_plain_takes_a_stratum_a_lane():
    """bdpt_kernel.stratum_plain with each lane's own stratum (chip_smoke.py
    phase 27b's plain version, the north-star's last strata as lanes) equals
    its calls at one stratum each, lane for lane, counters summed."""
    W, H, SQRT, DEPTH = 1920, 1080, 32, 2
    tl = tload(GLASS, dtype=torch.float32, device="cpu", verbose=False)
    cct = tcam.camera_constants(dataclasses.replace(
        tl.camera, image_width=W, aspect_ratio=16 / 9, samples_per_pixel=SQRT * SQRT),
        torch.float32)
    ts, tcam13 = dataclasses.replace(tl.scene, use_bvh=False), tk.camera_table(cct)
    pix = torch.arange(W * H - 4, W * H, dtype=torch.int32)
    i, j = (pix % W).float(), (pix // W).float()
    k = torch.tensor([1022, 1023]).repeat_interleave(4)
    got = tbk.stratum_plain(ts, i.repeat(2), j.repeat(2), pix.repeat(2), tcam13,
                            rng.prng_key(0), DEPTH, SQRT, k, mis=True)
    want = [tbk.stratum_plain(ts, i, j, pix, tcam13, rng.prng_key(0), DEPTH, SQRT, s, mis=True)
            for s in (1022, 1023)]
    np.testing.assert_array_equal(got[0].numpy(), torch.cat([w[0] for w in want]).numpy())
    assert [int(x) for x in got[1:3]] == [sum(int(w[n]) for w in want) for n in (1, 2)]
    assert got[3].tolist() == (want[0][3] + want[1][3]).tolist() and got[0].any()
