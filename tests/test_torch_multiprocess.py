"""bpt_tpu_torch's multi-process rendering: real OS processes joined by
``torch.distributed`` over gloo on the CPU, started by ``launch_local``
and by ``python -m bpt_tpu_torch.parallel.launch``, at the sizes of
``tests/test_multiprocess.py`` (24x24, 4 spp, depth 3).  Two processes'
gathered pixel shards equal the one-process ``render()`` and
``render_distributed`` to the bit; two processes' strata summed with
``all_reduce`` equal the in-process sample sharding to the bit and the
stratum loop within rtol 1e-5 / atol 1e-6; a failing worker surfaces as
RuntimeError; ``init_multiprocess`` refuses what it cannot honour
instead of falling back."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.parallel import render_distributed, render_multiprocess, render_spp_sharded
from bpt_tpu_torch.parallel.multiprocess import init_multiprocess, launch_local
from bpt_tpu_torch.scene import presets as tpresets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIZE, SPP, DEPTH, SEED = 24, 4, 3, 7


def _args(out, integrator, *extra):
    return ["--size", f"{SIZE}x{SIZE}", "--spp", str(SPP), "--max-depth", str(DEPTH),
            "--integrator", integrator, "--seed", str(SEED), "--output", str(out), *extra]


def _cfg(integrator):
    return dataclasses.replace(tpresets.cornell_box_camera(), image_width=SIZE,
                               aspect_ratio=1.0, samples_per_pixel=SPP, max_depth=DEPTH,
                               integrator=integrator)


def _launches(outs):
    """Each rank's printed launch counts, by rank."""
    got = {}
    for out in outs:
        for m in re.finditer(r"\[worker (\d+)/2\] .* launches=(\{.*\}) plain_calls=(\{.*\})",
                             out):
            got[int(m.group(1))] = {**json.loads(m.group(2)), **json.loads(m.group(3))}
    return got


@pytest.mark.parametrize("integrator,via", [("pt", "module"), ("bdpt-mis", "launch_local")])
def test_two_processes_equal_one_process(tmp_path, integrator, via):
    """pt through the launcher's module entry point, bdpt-mis (the fused
    loop's MIS kernel) through ``launch_local``."""
    out = tmp_path / "fb.npy"
    if via == "module":
        proc = subprocess.run(
            [sys.executable, "-m", "bpt_tpu_torch.parallel.launch", "-n", "2", "--device",
             "cpu", "--timeout", "240", "--", *_args(out, integrator)],
            capture_output=True, text=True, cwd=ROOT, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        outs = [proc.stdout]
    else:
        outs = launch_local(2, _args(out, integrator), device="cpu", timeout=240.0)
    launches = _launches(outs)
    assert sorted(launches) == [0, 1]
    kernel = "pt_megakernel_pixels_plain" if integrator == "pt" else "bdpt_megakernel_pixels_plain"
    assert all(counts.get(kernel) == 1 for counts in launches.values())  # one chunk a rank
    fb = np.load(out)
    scene, cfg = tpresets.cornell_box(device="cpu"), _cfg(integrator)
    want = trender.render(scene, cfg, seed=SEED)
    np.testing.assert_array_equal(fb, want.framebuffer_sum)
    one, _, _ = render_distributed(scene, cfg, mesh=[CPU], seed=SEED)
    np.testing.assert_array_equal(fb, one)


def test_spp_sharded_over_two_processes(tmp_path):
    """A stratum a rank, summed with all_reduce: equal to the in-process
    sum over two devices (a + b either way) and within tolerance of the
    stratum loop, whose adds run in another order."""
    out = tmp_path / "fb.npy"
    outs = launch_local(2, _args(out, "pt", "--shard", "spp"), device="cpu", timeout=240.0)
    assert sorted(_launches(outs)) == [0, 1]
    fb = np.load(out)
    scene, cfg = tpresets.cornell_box(device="cpu"), _cfg("pt")
    want = 0.0
    for s0 in (0, 2):
        want = want + render_spp_sharded(scene, cfg, mesh=[CPU] * 2, seed=SEED, s0=s0)[0]
    np.testing.assert_array_equal(fb, want)
    cc = camera_constants(cfg, scene.dtype)
    loop = torch.zeros((SIZE * SIZE, 3))
    trender._render_strata(scene, cfg, cc, "pt", SEED, loop, None, None, None)
    np.testing.assert_allclose(fb, loop.numpy().reshape(SIZE, SIZE, 3), rtol=1e-5, atol=1e-6)


def test_launch_local_surfaces_worker_failure(tmp_path):
    with pytest.raises(RuntimeError, match=r"(?s)worker \d exited 2:.*--size must be WxH"):
        launch_local(2, ["--size", "notasize", "--output", str(tmp_path / "x.npy")],
                     device="cpu", timeout=240.0)


def test_init_multiprocess_refuses_what_it_cannot_honour(monkeypatch):
    """No fallback: a CUDA rank without a card, nccl with more ranks than
    cards and nccl on the CPU raise before joining a group; rendering
    without a group raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_multiprocess(0, 1, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="nccl needs a card a rank: 2 ranks, 1 card"):
        init_multiprocess(0, 2, device="cuda")
    with pytest.raises(ValueError, match="nccl needs device='cuda'"):
        init_multiprocess(0, 2, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="call init_multiprocess first"):
        render_multiprocess(tpresets.cornell_box(device="cpu"), _cfg("pt"))
