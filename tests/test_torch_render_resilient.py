"""bpt_tpu_torch's ``render_resilient`` on each checkpointing route, as
``tests/test_render.py:249-330`` holds bpt_tpu's: it resumes after a
failure, survives many spaced failures and exhausts its retries.  The
failure is a RuntimeError raised by the route's wrapper (the megakernel
of the fused loop, ``pt_wave``, the stratum loop's estimator) at chosen
calls, mid-render; the resumed image equals the uninterrupted render's
to the bit (its counters, as bpt_tpu's, count the units of the last
attempt only: a checkpoint holds no counters).  Each render has four units: the fused loop's four
chunks of 16 pixels, and one stratum a batch on the other loops."""

import dataclasses

import numpy as np
import pytest
import torch

from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_scene

SEED = 21


class Flaky:
    """``fn``, raising at the calls (1-based) for which ``fails`` is true."""

    def __init__(self, fn, fails):
        self.fn, self.fails, self.calls, self.raised = fn, fails, 0, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        if self.fails(self.calls):
            self.raised += 1
            raise RuntimeError("injected device failure")
        return self.fn(*args, **kw)


def _route_case(route, monkeypatch):
    """(scene, camera, render kwargs, name of the wrapper in models.render)."""
    cornell_cfg = dataclasses.replace(tpresets.cornell_box_camera(), image_width=8,
                                      samples_per_pixel=4, max_depth=3, integrator="pt")
    if route == "fused":
        return tpresets.cornell_box(device="cpu"), cornell_cfg, {"chunk_size": 16}, \
            "pt_megakernel_pixels"
    monkeypatch.setattr(trender, "_wave_spp_batch", lambda npix, spp: 1)
    if route == "wave":
        cfg = CameraConfig(image_width=8, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
                           vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0),
                           integrator="pt")
        return big_scene(tbuilder, device="cpu"), cfg, {}, "pt_wave"
    return (tpresets.cornell_box(device="cpu", dtype=torch.float64), cornell_cfg, {},
            "path_trace_pixels_fast")


@pytest.fixture(params=["fused", "wave", "strata"])
def case(request, monkeypatch):
    scene, cfg, kw, wrapper = _route_case(request.param, monkeypatch)
    assert trender._route(scene, cfg, "pt", None) == request.param
    clean = trender.render(scene, cfg, seed=SEED, **kw)

    fn = getattr(trender, wrapper)

    def flaky(fails):
        f = Flaky(fn, fails)
        monkeypatch.setattr(trender, wrapper, f)
        return f

    return scene, cfg, kw, clean, flaky


def test_resumes_after_a_failure(case):
    """The third unit fails once: the render resumes after the two done,
    and no unit is rendered twice (the wrapper ran four times and once
    more for the failed call)."""
    scene, cfg, kw, clean, flaky = case
    f = flaky(lambda n: n == 3)
    seen = []
    got = trender.render_resilient(scene, cfg, seed=SEED, retries=3,
                                   stratum_callback=lambda s: seen.append(s["units_done"]), **kw)
    np.testing.assert_array_equal(got.framebuffer_sum, clean.framebuffer_sum)
    assert (f.raised, f.calls) == (1, 5)
    assert seen == [1, 2, 3, 4]


def test_survives_many_spaced_failures(case):
    """Every unit after the first fails once, retries=1: each failure
    follows progress, so the count of attempts resets and the render
    ends."""
    scene, cfg, kw, clean, flaky = case
    f = flaky(lambda n: n % 2 == 0)
    got = trender.render_resilient(scene, cfg, seed=SEED, retries=1, **kw)
    np.testing.assert_array_equal(got.framebuffer_sum, clean.framebuffer_sum)
    assert (f.raised, f.calls) == (3, 7)


def test_exhausts_its_retries(case):
    """With no checkpoint yet a failure re-raises at once; after one unit,
    retries=2 failures in a row without progress, and the third raises."""
    scene, cfg, kw, _, flaky = case
    f = flaky(lambda n: True)
    with pytest.raises(RuntimeError, match="injected"):
        trender.render_resilient(scene, cfg, seed=SEED, retries=2, **kw)
    assert f.calls == 1
    f = flaky(lambda n: n > 1)
    with pytest.raises(RuntimeError, match="injected"):
        trender.render_resilient(scene, cfg, seed=SEED, retries=2, **kw)
    assert (f.calls, f.raised) == (4, 3)
