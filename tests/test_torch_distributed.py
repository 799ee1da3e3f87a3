"""bpt_tpu_torch's multi-device rendering on CPU meshes (``[cpu] * n``):
pixel sharding (``parallel.mesh.render_distributed``) against ``render()``
on every route at mesh sizes 1, 3 and 8 (16x16 = 256 pixels: 3 does not
divide it, 8 leaves no shard empty), to the bit with every counter equal;
sample sharding and the (host, chip) mesh against the single-device
stratum loop within rtol 1e-5 / atol 1e-6 (``tests/test_distributed.py``'s
tolerance: the sum over strata runs in another order); the ``fast``
switch's gates; and one card test (``[cuda:0] * 2``).  bpt_tpu's own
``render_distributed`` is held against the port in
``test_torch_distributed_parity.py``."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.ops.kernels.pt_kernel import megakernel_reject_reason
from bpt_tpu_torch.parallel import make_mesh, render_distributed, render_spp_sharded
from bpt_tpu_torch.parallel.mesh import (
    make_mesh_2d,
    render_distributed_2d,
    scene_on,
    shard_route,
)
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_scene

CPU = torch.device("cpu")
SEED = 7
DEFOCUS = dict(defocus_angle=1.0, focus_dist=1078.0)  # the focus plane at the room's centre


def _cornell_cfg(integrator, width=16, **kw):
    return dataclasses.replace(tpresets.cornell_box_camera(), image_width=width,
                               samples_per_pixel=4, max_depth=3, integrator=integrator, **kw)


def _big_cfg(integrator, width=8, depth=3):
    return CameraConfig(image_width=width, aspect_ratio=1.0, samples_per_pixel=4,
                        max_depth=depth, vfov=40.0, lookfrom=(0.0, 2.0, 6.0),
                        lookat=(0.0, 1.0, 0.0), integrator=integrator)


@pytest.fixture(scope="module")
def cornell():
    return tpresets.cornell_box(device="cpu")


@pytest.fixture(scope="module")
def big():
    return big_scene(tbuilder, device="cpu")


# route id: (scene fixture, camera, route render() takes)
ROUTES = {
    "fused-pt": ("cornell", _cornell_cfg("pt"), "fused"),
    "fused-bdpt": ("cornell", _cornell_cfg("bdpt"), "fused"),
    "fused-bdpt-mis": ("cornell", _cornell_cfg("bdpt-mis"), "fused"),
    "pt_wave": ("big", _big_cfg("pt"), "wave"),
    "strata-defocus": ("cornell", _cornell_cfg("bdpt-mis", **DEFOCUS), "strata"),
    "bdpt_wave": ("big", _big_cfg("bdpt-mis"), "bdpt_wave"),
}


@pytest.fixture(scope="module")
def renders():
    """render() of each route's configuration, computed once."""
    cache = {}

    def get(name, scene):
        if name not in cache:
            cache[name] = trender.render(scene, ROUTES[name][1], seed=SEED)
        return cache[name]

    return get


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("name", list(ROUTES))
def test_pixel_sharded_equals_render(name, n, renders, request, monkeypatch):
    which, cfg, route = ROUTES[name]
    scene = request.getfixturevalue(which)
    if route == "bdpt_wave":  # the BDPT wave loop at a tiny size
        monkeypatch.setattr(trender, "WAVE_MIN_RAYS", 1)
    assert trender._route(scene, cfg, cfg.integrator, None) == route
    want = renders(name, scene)
    fb, spp, stats = render_distributed(scene, cfg, mesh=[CPU] * n, seed=SEED)
    assert spp == 4 and float(fb.mean()) > 0.0
    np.testing.assert_array_equal(fb, want.framebuffer_sum)
    assert dataclasses.replace(stats, wall_seconds=0) == dataclasses.replace(
        want.stats, wall_seconds=0)


def test_shards_past_the_image_are_empty(cornell):
    """A mesh larger than the image: the shards past its pixels render
    nothing, the image is render()'s."""
    cfg = _cornell_cfg("pt", width=2, aspect_ratio=1.0)
    want = trender.render(cornell, cfg, seed=SEED)
    fb, _, stats = render_distributed(cornell, cfg, mesh=[CPU] * 6, seed=SEED)
    np.testing.assert_array_equal(fb, want.framebuffer_sum)
    assert stats.rays_traced == want.stats.rays_traced


def test_scene_copied_once_to_another_device(cornell):
    """A mesh device other than the scene's gets the scene's copy, made
    once while the scene lives (``cpu:0`` is another device to torch than
    the scene's ``cpu``), and renders the same image."""
    other = torch.device("cpu", 0)
    assert other != cornell.device
    copy = scene_on(cornell, other)
    assert copy is not cornell and scene_on(cornell, other) is copy
    assert scene_on(cornell, cornell.device) is cornell
    cfg = _cornell_cfg("bdpt", width=8)
    want = trender.render(cornell, cfg, seed=SEED)
    fb, _, stats = render_distributed(cornell, cfg, mesh=[other, CPU], seed=SEED)
    np.testing.assert_array_equal(fb, want.framebuffer_sum)
    assert stats.shadow_rays == want.stats.shadow_rays


def _stratum_loop(scene, cfg):
    """The single-device stratum loop (render() sends these configurations
    to the fused loop)."""
    cc = camera_constants(cfg, scene.dtype, scene.device)
    fb = torch.zeros((cc.width * cc.height, 3), dtype=scene.dtype)
    counts = trender._render_strata(scene, cfg, cc, cfg.integrator, SEED, fb, None, None, None)
    return fb.numpy().reshape(cc.height, cc.width, 3), counts


@pytest.mark.parametrize("integrator", ["pt", "bdpt-mis"])
def test_spp_sharded_within_tolerance_of_the_stratum_loop(cornell, integrator):
    """Three devices, two batches (strata 0-2, then 3 and two past spp_eff
    that add zero), summed in device order; the rays equal the loop's."""
    cfg = _cornell_cfg(integrator)
    want, (rays, shadow, _) = _stratum_loop(cornell, cfg)
    fb, total_rays, total_shadow = 0.0, 0, 0
    for s0 in (0, 3):
        part, stats = render_spp_sharded(cornell, cfg, mesh=[CPU] * 3, seed=SEED, s0=s0)
        fb, total_rays = fb + part, total_rays + stats.rays_traced
        total_shadow += stats.shadow_rays
    np.testing.assert_allclose(fb, want, rtol=1e-5, atol=1e-6)
    assert (total_rays, total_shadow) == (int(rays), int(shadow))


@pytest.mark.parametrize("hosts,chips", [(2, 4), (4, 2)])
def test_2d_mesh_within_tolerance_of_the_stratum_loop(cornell, hosts, chips):
    cfg = _cornell_cfg("pt")
    want, (rays, _, _) = _stratum_loop(cornell, cfg)
    mesh = make_mesh_2d(hosts, chips, devices=[CPU] * 8)
    assert [len(row) for row in mesh] == [chips] * hosts
    fb, spp, stats = render_distributed_2d(cornell, cfg, mesh, seed=SEED)
    assert spp == 4
    np.testing.assert_allclose(fb, want, rtol=1e-5, atol=1e-6)
    assert stats.rays_traced == int(rays)


def test_fast_switch_routes(cornell, big):
    """bpt_tpu's values (parallel/mesh.py:480-517): 'auto' is render()'s
    route, 'never' the stratum loop (the image of the loop, though render()
    takes the fused loop here), 'wave' pt_wave or the BDPT wave loop."""
    cfg = _cornell_cfg("bdpt", width=8)
    assert shard_route(cornell, cfg, "bdpt", "auto") == "fused"
    assert shard_route(cornell, cfg, "bdpt", "always") == "fused"
    assert shard_route(cornell, cfg, "bdpt", "never") == "strata"
    assert shard_route(big, _big_cfg("pt"), "pt", "wave") == "wave"
    assert shard_route(big, _big_cfg("bdpt"), "bdpt", "wave") == "bdpt_wave"
    fb, _, _ = render_distributed(cornell, cfg, mesh=[CPU] * 2, seed=SEED, fast="never")
    want, _ = _stratum_loop(cornell, cfg)
    np.testing.assert_array_equal(fb, want)


def _gate(case, cornell, big):
    """(scene, camera, fast, exception, message) of a gate."""
    f64 = tpresets.cornell_box(device="cpu", dtype=torch.float64)
    reason = megakernel_reject_reason(f64, "bdpt")
    assert reason.startswith("dtype")
    return {
        "unknown": (cornell, _cornell_cfg("pt"), "sometimes", ValueError,
                    "fast must be 'auto'|'always'|'never'|'wave', got 'sometimes'"),
        "wave-past-unroll": (big, _big_cfg("bdpt", depth=trender.UNROLL_MAX + 1), "wave",
                             ValueError, "requires max_depth <= UNROLL_MAX"),
        "always-refused": (f64, _cornell_cfg("bdpt"), "always", NotImplementedError, reason),
        "always-defocus": (cornell, _cornell_cfg("pt", **DEFOCUS), "always",
                           NotImplementedError, "neither defocus nor ref_vis"),
    }[case]


@pytest.mark.parametrize("case", ["unknown", "wave-past-unroll", "always-refused",
                                  "always-defocus"])
def test_fast_switch_gates(case, cornell, big):
    """bpt_tpu's words (parallel/mesh.py:480-500): an unknown value and
    'wave' with BDPT past UNROLL_MAX raise ValueError; 'always' where the
    megakernels refuse the scene raises NotImplementedError with their
    reason, and so does 'always' with defocus, which they do not render."""
    scene, cfg, fast, exc, msg = _gate(case, cornell, big)
    with pytest.raises(exc, match=re.escape(msg)):
        render_distributed(scene, cfg, mesh=[CPU], fast=fast)


def test_make_mesh_needs_devices_named_on_a_cpu_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(devices=["cuda:0"])
    assert make_mesh(2, devices=[CPU] * 3) == [CPU, CPU]
    with pytest.raises(ValueError):
        make_mesh(4, devices=[CPU] * 3)


@pytest.mark.gpu
def test_card_mesh_equals_render():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scene = tpresets.cornell_box(device="cuda")
    for integrator in ("pt", "bdpt"):
        cfg = _cornell_cfg(integrator, width=64)
        want = trender.render(scene, cfg, seed=SEED)
        fb, _, stats = render_distributed(scene, cfg, mesh=["cuda:0"] * 2, seed=SEED)
        np.testing.assert_array_equal(fb, want.framebuffer_sum)
        assert stats.rays_traced == want.stats.rays_traced
