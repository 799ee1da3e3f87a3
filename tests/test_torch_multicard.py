"""bpt_tpu_torch's multi-device rendering across several cards (every
visible card), against ``render()`` on card 0, for the cornell box with
bdpt (the CLI's default) and the coffee stand-in with pt (``pt_wave``) at
512x512, 16 spp, depth 10:

* ``render_distributed`` over ``make_mesh()`` (a shard a card, in one
  process): image and counters equal to ``render()``'s to the bit;
* ``launch_local(cards, device="cuda")``, a nccl rank a card, pixel
  sharded: the gathered image equal to ``render()``'s to the bit, each
  rank's kernels launched and no plain version called;
* the same ranks sample sharded (a stratum a rank, summed with
  ``all_reduce``): within rtol 1e-5 / atol 1e-6 of the stratum loop on
  card 0, rays equal.

Skips below two cards.  Run on a host with two or more cards:

    python -m pytest -m gpu tests/test_torch_multicard.py -q -s --noconftest

With ``-s`` it prints the walls (one warm-up, three timed renders) beside
the card's name and power limit."""

import dataclasses
import json
import re
import statistics
import subprocess

import numpy as np
import pytest
import torch

from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.parallel import make_mesh, render_distributed
from bpt_tpu_torch.parallel.multiprocess import launch_local
from bpt_tpu_torch.scene.loader import load_scene_from_yaml
from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

pytestmark = pytest.mark.gpu

SIZE, SPP, DEPTH, SEED = 512, 16, 10, 0
COFFEE = "scenes/coffee/coffee_standin.yaml"
# case id: (--scene, integrator)
CASES = {"cornell-bdpt": ("cornell", "bdpt"), "coffee-pt": (COFFEE, "pt")}


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    return make_mesh(), name


@pytest.fixture(scope="module", params=list(CASES))
def case(request, cards):
    mesh, card = cards
    scene_arg, integrator = CASES[request.param]
    if scene_arg == "cornell":
        scene, cfg = cornell_box(device=mesh[0]), cornell_box_camera()
    else:
        loaded = load_scene_from_yaml(scene_arg, device=mesh[0], verbose=False)
        scene, cfg = loaded.scene, loaded.camera
    cfg = dataclasses.replace(cfg, image_width=SIZE, aspect_ratio=1.0, samples_per_pixel=SPP,
                              max_depth=DEPTH, integrator=integrator)
    trender.render(scene, cfg, seed=SEED)
    refs = [trender.render(scene, cfg, seed=SEED) for _ in range(3)]
    walls = [r.stats.wall_seconds for r in refs]
    print(f"\n{request.param} {SIZE}x{SIZE} {SPP} spp depth {DEPTH}: render() on {mesh[0]} "
          f"walls {walls} s, median {statistics.median(walls):.6f} s, rays "
          f"{refs[0].stats.rays_traced} ({card})")
    return dict(id=request.param, scene=scene, cfg=cfg, scene_arg=scene_arg,
                integrator=integrator, ref=refs[0], mesh=mesh, card=card)


def _ranks(case, shard, tmp_path):
    out = tmp_path / f"{case['id']}_{shard}.npy"
    outs = launch_local(len(case["mesh"]), [
        "--scene", case["scene_arg"], "--size", f"{SIZE}x{SIZE}", "--spp", str(SPP),
        "--max-depth", str(DEPTH), "--integrator", case["integrator"], "--seed", str(SEED),
        "--shard", shard, "--output", str(out)], device="cuda", timeout=600.0)
    rays = []
    for o in outs:
        line = next(ln for ln in o.splitlines() if ln.startswith("[worker ") and "launches=" in ln)
        print(f"  {line} ({case['card']})")
        assert "backend=nccl" in line
        launches = json.loads(re.search(r"launches=(\{.*?\})", line).group(1))
        assert sum(launches.values()) > 0 and "plain_calls={}" in line
        rays.append(int(re.search(r" rays=(\d+)", line).group(1)))
    return np.load(out), rays


def test_mesh_over_every_card_equals_render(case):
    ref = case["ref"]
    render_distributed(case["scene"], case["cfg"], mesh=case["mesh"], seed=SEED)
    runs = [render_distributed(case["scene"], case["cfg"], mesh=case["mesh"], seed=SEED)
            for _ in range(3)]
    walls = [st.wall_seconds for _, _, st in runs]
    print(f"  render_distributed over {[str(d) for d in case['mesh']]}: walls {walls} s, "
          f"median {statistics.median(walls):.6f} s ({case['card']})")
    for fb, spp_eff, st in runs:
        np.testing.assert_array_equal(fb, ref.framebuffer_sum)
        assert spp_eff == SPP
        assert dataclasses.replace(st, wall_seconds=0) == dataclasses.replace(
            ref.stats, wall_seconds=0)


def test_nccl_ranks_pixel_sharded_equal_render(case, tmp_path):
    fb, rays = _ranks(case, "pixels", tmp_path)
    np.testing.assert_array_equal(fb, case["ref"].framebuffer_sum)
    assert rays == [case["ref"].stats.rays_traced] * len(case["mesh"])


def test_nccl_ranks_sample_sharded_match_the_stratum_loop(case, tmp_path):
    fb, rays = _ranks(case, "spp", tmp_path)
    scene, cfg = case["scene"], case["cfg"]
    cc = camera_constants(cfg, scene.dtype, scene.device)
    loop = torch.zeros((SIZE * SIZE, 3), dtype=scene.dtype, device=scene.device)
    loop_rays = int(trender._render_strata(scene, cfg, cc, case["integrator"], SEED, loop,
                                           None, None, None)[0])
    want = loop.cpu().numpy().reshape(fb.shape)
    print(f"  sample sharded: max abs err {float(np.abs(fb - want).max()):.3e} against the "
          f"stratum loop ({case['card']})")
    np.testing.assert_allclose(fb, want, rtol=1e-5, atol=1e-6)
    assert rays == [loop_rays] * len(case["mesh"])
