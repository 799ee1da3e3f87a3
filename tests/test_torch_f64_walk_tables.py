"""The float64 BVH walk's tables and what its kernels rely on, and the
float64 BDPT wave budget, on the CPU.

``walk_tables64`` packs a node as one 64-byte record and a triangle as one
80-byte row (``csrc/bvh_walk.cuh``: ``Bvh64``); here they unpack to the
scene's BVH and triangles bit for bit, on the 964-triangle scene and the
coffee stand-in.  The kernels ``bvh64<false>`` / ``bvh64<true>``
(``csrc/pt_wave.cu``) keep their lane counters in 32 bits because a walk
visits a node at most once and tests a triangle at most once (its skip
links only go forward), and recompute the closest hit's (u, v) at the
walk's end from the winning triangle; both are checked on the plain walk
the kernels are held against, and the walk against ``bpt_tpu``'s jnp walk.
``models/render.py::BYTES_PER_RAY`` sizes float64 BDPT waves by float64
bytes a ray, and float32 waves as before; the image does not depend on
the waves.  Tolerances: tables, hits, counters and images exact; (u, v)
against ``bpt_tpu`` to 1e-12 (XLA's CPU backend contracts a*b+c)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import vec3 as jv3
from bpt_tpu.ops import soa as jsoa
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import render as trender
from bpt_tpu_torch.ops import soa as tsoa
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene.loader import load_scene_from_yaml
from bpt_tpu_torch.scene.types import CameraConfig
from torch_parity import big_rays, big_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COFFEE = os.path.join(ROOT, "scenes", "coffee", "coffee_standin.yaml")

# The float32 coefficients from before float64 had its own: the
# float32 wave shapes must not move.
F32_BYTES_PER_RAY = {False: (0, 470, 160), True: (15, 440, 900)}


@pytest.fixture(scope="module", params=["big", "coffee"])
def scene64(request):
    if request.param == "big":
        return big_scene(tbuilder, device="cpu", dtype=torch.float64)
    return load_scene_from_yaml(COFFEE, dtype=torch.float64, device="cpu",
                                verbose=False).scene


def test_float64_node_records_and_triangle_rows_unpack_to_the_scene(scene64):
    """Node k's 64-byte record holds its box as (min, max) pairs of x, y, z,
    then skip and first*4 + count as two int32 and a zero pad; triangle
    k's 80-byte row holds v0, e1, e2 and a zero pad.  Packed at the first
    call and kept with the scene: the second call returns the same
    tensors."""
    nodes, tris = tw.walk_tables64(scene64)
    N, T = scene64.bvh_min.shape[0], scene64.num_tris
    assert nodes.shape == (N, 8) and tris.shape == (T, 10)
    assert nodes.dtype == tris.dtype == torch.float64
    assert nodes.is_contiguous() and tris.is_contiguous()
    assert nodes.element_size() * nodes.shape[1] == 64 and tris.element_size() * 10 == 80
    box = nodes[:, :6].reshape(N, 3, 2)
    assert torch.equal(box[:, :, 0], scene64.bvh_min) and torch.equal(box[:, :, 1],
                                                                       scene64.bvh_max)
    ints = nodes.view(torch.int32)[:, 12:16].long()
    assert torch.equal(ints[:, 0], scene64.bvh_skip.long())
    assert torch.equal(ints[:, 1] >> 2, scene64.bvh_first.long())
    assert torch.equal(ints[:, 1] & 3, scene64.bvh_count.long())
    assert not bool(ints[:, 2:].any()) and not bool(tris[:, 9].any())
    for k, a in enumerate((scene64.v0, scene64.e1, scene64.e2)):
        assert torch.equal(tris[:, 3 * k:3 * k + 3], a)
    assert all(x is y for x, y in zip(tw.walk_tables64(scene64), (nodes, tris)))
    assert id(scene64) in tw.walk_tables64.cache


def test_float64_bounds_flags(scene64):
    """The float64 walks' scene flag ``bounds_ordered``: every node bound
    finite and every node's min <= max; an inverted box, an infinite bound
    or a NaN bound clears it, and ``bounds_ok`` reads only the NaN."""
    assert tw.bounds_ordered(scene64) is True
    flipped = scene64.bvh_max.clone()
    flipped[-1, 0] = scene64.bvh_min[-1, 0] - 1.0
    assert tw.bounds_ordered(dataclasses.replace(scene64, bvh_max=flipped)) is False
    assert tw.bounds_ok(dataclasses.replace(scene64, bvh_max=flipped)) is True
    inf_max = scene64.bvh_max.clone()
    inf_max[-1, 1] = torch.inf
    assert tw.bounds_ordered(dataclasses.replace(scene64, bvh_max=inf_max)) is False
    nan_min = scene64.bvh_min.clone()
    nan_min[0, 2] = torch.nan
    assert tw.bounds_ordered(dataclasses.replace(scene64, bvh_min=nan_min)) is False
    assert tw.bounds_ok(dataclasses.replace(scene64, bvh_min=nan_min)) is False


def test_chip_smoke_reads_the_float64_walks_ptxas_lines():
    """chip_smoke.py phase 26 prints the float64 walks' registers and
    spills from ptxas's -v lines, whose register line comes after the
    function properties and the spill line."""
    import chip_smoke

    log = []
    for name, regs, spill in (("_ZN3bpt5bvh64ILb0EEEvNS_8Params64E", 76, (0, 0)),
                              ("_ZN3bpt5bvh64ILb1EEEvNS_8Params64E", 79, (8, 32)),
                              ("_ZN3bpt11closest_bvhENS_13ClosestParamsE", 58, (0, 0))):
        log += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    8 bytes stack frame, {spill[0]} bytes spill stores, {spill[1]} bytes "
                "spill loads",
                f"ptxas info    : Used {regs} registers, used 0 barriers"]
    got = chip_smoke.bvh64_ptxas(log)
    assert got == {
        "closest": dict(kernel="_ZN3bpt5bvh64ILb0EEEvNS_8Params64E", registers=76,
                        spill_stores=0, spill_loads=0),
        "any": dict(kernel="_ZN3bpt5bvh64ILb1EEEvNS_8Params64E", registers=79,
                    spill_stores=8, spill_loads=32)}


def test_a_walk_adds_under_2_to_the_31_to_each_count(scene64):
    """What lets the float64 kernels keep their lane counters in 32 bits
    and flush them at 2^31: every skip link points past its node, so the
    walk's next node only grows and it visits a node at most once, and the
    leaves' triangle ranges are disjoint, so it tests a triangle at most
    once; N and T (and first*4 + count) fit an int32."""
    N, T = scene64.bvh_min.shape[0], scene64.num_tris
    skip = scene64.bvh_skip.long()
    assert bool((skip > torch.arange(N)).all()) and int(skip.max()) <= N
    leaf = scene64.bvh_count > 0
    first, count = scene64.bvh_first.long()[leaf], scene64.bvh_count.long()[leaf]
    order = torch.argsort(first)
    ends = (first + count)[order]
    assert bool((ends[:-1] <= first[order][1:]).all()) and int(ends.max()) <= T
    assert int(count.sum()) == T
    assert N < 2**31 and int((scene64.bvh_first.long() * 4 + scene64.bvh_count).max()) < 2**31
    # the plain walk's counts over rays that hit: a lane's visits <= N and tests <= T
    o, d = (x.astype(np.float64) for x in big_rays(64, 7))
    lo, hi = (x.numpy() for x in (scene64.bvh_min[0], scene64.bvh_max[0]))
    o = lo + (hi - lo) * (o - o.min(0)) / np.ptp(o, axis=0).clip(1e-9)
    for k in range(4):
        lane = Vec3(*torch.from_numpy(o[k:k + 1]).unbind(1)), Vec3(
            *torch.from_numpy(d[k:k + 1]).unbind(1))
        h = tsoa.bvh_closest(scene64, *lane, 1e-3, torch.inf)
        assert 0 < int(h.node_visits) <= N and int(h.tri_tests) <= T


def test_closest_uv_recomputed_from_the_winner_is_the_walks():
    """The float64 closest kernel keeps no (u, v) in its loop and tests the
    winning triangle again at the walk's end: on the plain walk's
    arithmetic that second test gives the accepted test's (u, v) bit for
    bit, and both are bpt_tpu's jnp walk's within 1e-12."""
    scene = big_scene(tbuilder, device="cpu", dtype=torch.float64)
    o, d = (x.astype(np.float64) for x in big_rays(2000, 11))
    ov, dv = (Vec3(*torch.from_numpy(np.ascontiguousarray(a)).unbind(1)) for a in (o, d))
    h = tsoa.bvh_closest(scene, ov, dv, 1e-3, torch.inf)
    assert 0.2 < float(h.hit.double().mean()) < 0.95
    det, t, u, v = tsoa._mt_lanes(*(v3.gather(a, h.tri) for a in (scene.v0, scene.e1,
                                                                   scene.e2)), ov, dv)
    assert torch.equal(u[h.hit], h.u[h.hit]) and torch.equal(v[h.hit], h.v[h.hit])
    assert torch.equal(t[h.hit], h.t[h.hit])
    js = big_scene(jbuilder, dtype=jnp.float64)
    want = jsoa.closest_hit(js, jv3.from_array(jnp.asarray(o)), jv3.from_array(jnp.asarray(d)),
                            1e-3, jnp.inf)
    hit = h.hit.numpy()
    np.testing.assert_array_equal(np.asarray(want.hit), hit)
    for got, ref in ((u, want.u), (v, want.v)):
        np.testing.assert_allclose(got.numpy()[hit], np.asarray(ref)[hit], rtol=1e-12,
                                   atol=1e-12)


DEPTHS = (2, 3, 5, 8, 10, 16, 20, 32, 40, 64, 80)
SHAPES = ((512 * 512, 4), (512 * 512, 16), (640 * 360, 64), (64 * 64, 4))


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
def test_float32_wave_shapes_are_unchanged(mis):
    """Float32 BDPT waves keep the shapes of the float32 coefficients that
    were the only ones before float64 had its own, at every depth 2-80."""
    a, b, c = F32_BYTES_PER_RAY[mis]
    assert trender.BYTES_PER_RAY[torch.float32][mis] == (a, b, c)
    for npix, spp in SHAPES:
        for S in DEPTHS:
            cap = max(1, trender.BDPT_WAVE_BYTES // (a * S * S + b * S + c))
            want = (min(spp, cap // npix), npix) if cap >= npix else (1, cap)
            assert trender._bdpt_wave_shape(npix, spp, S, mis) == want
            assert trender._bdpt_wave_shape(npix, spp, S, mis, torch.float32) == want


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
def test_float64_waves_fit_the_budget_by_float64_bytes(mis):
    """A float64 wave's rays times the float64 bytes a ray stay under
    BDPT_WAVE_BYTES, and one more stratum (or pixel) would not: the wave
    is the largest the budget holds.  Float64 costs more bytes a ray than
    float32 at every depth, so its waves are never larger."""
    a, b, c = trender.BYTES_PER_RAY[torch.float64][mis]
    for npix, spp in SHAPES:
        for S in DEPTHS:
            per_ray = a * S * S + b * S + c
            assert per_ray > sum(x * y for x, y in zip(F32_BYTES_PER_RAY[mis], (S * S, S, 1)))
            strata, span = trender._bdpt_wave_shape(npix, spp, S, mis, torch.float64)
            assert strata * span * per_ray <= trender.BDPT_WAVE_BYTES
            if span < npix:
                assert strata == 1 and (span + 1) * per_ray > trender.BDPT_WAVE_BYTES
            elif strata < spp:
                assert (strata + 1) * npix * per_ray > trender.BDPT_WAVE_BYTES
            f32 = trender._bdpt_wave_shape(npix, spp, S, mis)
            assert strata * span <= f32[0] * f32[1]


W, SPP, DEPTH = 6, 4, 3


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_float64_stratum_loop_image_does_not_depend_on_the_budget(integrator, monkeypatch):
    """A float64 BDPT render of the 964-triangle scene on the CPU through
    the stratum loop (its hits from the plain BVH walk) gives the same
    image and counters bit for bit under the default budget (every stratum
    in one wave) and under one that holds 7 rays a wave (pixel ranges of
    7 within each stratum)."""
    scene = big_scene(tbuilder, device="cpu", dtype=torch.float64)
    cfg = CameraConfig(image_width=W, aspect_ratio=1.0, samples_per_pixel=SPP, max_depth=DEPTH,
                       vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0),
                       focus_dist=6.0, integrator=integrator)
    assert trender._route(scene, cfg, integrator, None) == "strata"
    mis = integrator == "bdpt-mis"
    assert trender._bdpt_wave_shape(W * W, SPP, DEPTH, mis, torch.float64) == (SPP, W * W)
    whole = trender.render(scene, cfg, seed=9)
    a, b, c = trender.BYTES_PER_RAY[torch.float64][mis]
    monkeypatch.setattr(trender, "BDPT_WAVE_BYTES", 7 * (a * DEPTH ** 2 + b * DEPTH + c))
    assert trender._bdpt_wave_shape(W * W, SPP, DEPTH, mis, torch.float64) == (1, 7)
    split = trender.render(scene, cfg, seed=9)
    np.testing.assert_array_equal(split.framebuffer_sum, whole.framebuffer_sum)
    assert dataclasses.replace(split.stats, wall_seconds=0) == dataclasses.replace(
        whole.stats, wall_seconds=0)
    assert whole.stats.shadow_rays > 0 and whole.stats.bvh_node_visits > 0
    assert float(whole.framebuffer_sum.mean()) > 0.0
