"""The CUDA kernels (PT and BDPT megakernels in their brute-force and walk
modes, the BVH closest and any hit, the per-bounce wave, the brute-force
closest and any hit, and the rolled and Plücker clustered closest and any
hit) against their plain PyTorch versions on the card, and the render
routes and hit dispatch through them.

Needs an NVIDIA card with sm_90a (H100) and nvcc; elsewhere every test
skips.  Run on the GPU machine with
    python -m pytest -m gpu tests/test_torch_cuda_kernels.py -q
Radiance tolerance rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes: a path can
take another branch on a one-ulp difference (the kernel's product-chain
Schlick vs the wavefront's pow, reduction order), and from there it is
another sample."""

import dataclasses

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.models.pt import NU
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
from bpt_tpu_torch.ops.kernels import intersect as ki
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.ops.kernels import pt_wave as pw
from bpt_tpu_torch.scene import builder, presets
from torch_parity import (
    big_rays,
    big_scene,
    mixed_scene,
    rays,
    shadow_wave,
    textured_wave_scene,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _scene(which):
    if which == "cornell":
        return presets.cornell_box(device="cuda")
    return mixed_scene(builder, presets, device="cuda")


def _frac_close(got, want):
    g = torch.stack(got[:3], 1)
    w = torch.stack(want[:3], 1)
    ok = ((g - w).abs() <= 1e-6 + 1e-4 * w.abs()).all(dim=1)
    return float(ok.double().mean())


@pytest.mark.parametrize("which", ["cornell", "mixed"])
@pytest.mark.parametrize("injected", [True, False], ids=["buffer", "rng"])
def test_rays_mode_matches_plain(which, injected):
    scene = _scene(which)
    B, depth = 8192, 6
    o, d = (torch.from_numpy(x).cuda() for x in rays(B, 3))
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    ids[::13] = -1
    u = (torch.from_numpy(np.random.default_rng(4).uniform(
        size=(depth * NU, B)).astype(np.float32)).cuda() if injected else None)
    ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
    n = pk.pt_megakernel.launches
    got = pk.pt_megakernel(scene, ov, dv, ids, rng.prng_key(2), depth, uniforms=u)
    want = pk.pt_megakernel_plain(scene, ov, dv, ids, rng.prng_key(2), depth, uniforms=u)
    torch.cuda.synchronize()
    assert pk.pt_megakernel.launches == n + 1
    assert _frac_close(got, want) >= 0.999
    assert all(float(c[::13].abs().max()) == 0.0 for c in got[:3])
    assert abs(int(got[3]) - int(want[3])) <= 1e-3 * int(want[3])


def test_pixels_mode_matches_plain_with_exact_counters():
    scene = _scene("cornell")
    W, S = 32, 4
    cc = camera_constants(dataclasses.replace(presets.cornell_box_camera(),
                                              image_width=W, samples_per_pixel=S * S),
                          torch.float32, "cuda")
    pix = torch.arange(W * W, device="cuda")
    i, j = (pix % W).float(), (pix // W).float()
    args = (scene, i, j, i * 0, j * 0, pix.int(), pk.camera_table(cc),
            rng.prng_key(0), 10)
    got = pk.pt_megakernel_pixels(*args, spp_loop=S * S, sqrt_spp=S)
    want = pk.pt_megakernel_pixels_plain(*args, spp_loop=S * S, sqrt_spp=S)
    torch.cuda.synchronize()
    assert _frac_close(got, want) >= 0.999
    assert int(got[3]) == int(want[3])
    assert got[4].tolist() == want[4].tolist()


def test_render_on_card_matches_cpu():
    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=16,
                              samples_per_pixel=4, max_depth=10, integrator="pt")
    gpu = render(presets.cornell_box(device="cuda"), cfg, seed=3)
    cpu = render(presets.cornell_box(device="cpu"), cfg, seed=3)
    ok = np.isclose(gpu.framebuffer_sum, cpu.framebuffer_sum, rtol=1e-4, atol=1e-6)
    assert ok.all(axis=-1).mean() >= 0.99
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= 10


def test_wrapper_rejects_what_the_kernel_cannot_take():
    scene = _scene("cornell")
    o = Vec3(*(torch.zeros(4, device="cuda") for _ in range(3)))
    ids = torch.arange(5, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="expected"):
        pk.pt_megakernel(scene, o, o, ids, rng.prng_key(0), 2)
    o64 = Vec3(*(x.double() for x in o))
    with pytest.raises(ValueError, match="float32"):
        pk.pt_megakernel(scene, o64, o64, ids[:4], rng.prng_key(0), 2)
    with pytest.raises(ValueError, match="float32"):
        pk.pt_megakernel(presets.cornell_box(dtype=torch.float64, device="cuda"),
                         o, o, ids[:4], rng.prng_key(0), 2)


def _counters(out):
    return [int(out[3]), int(out[4])] + [int(x) for x in out[5]]


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
@pytest.mark.parametrize("which", ["cornell", "mixed"])
@pytest.mark.parametrize("injected", [True, False], ids=["buffer", "rng"])
def test_bdpt_rays_mode_matches_plain(which, injected, mis):
    scene = _scene(which)
    B, depth = 8192, 6
    o, d = (torch.from_numpy(x).cuda() for x in rays(B, 5))
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    ids[::13] = -1
    u = (torch.from_numpy(np.random.default_rng(6).uniform(
        size=(bk.n_uniform_slots(depth), B)).astype(np.float32)).cuda()
        if injected else None)
    ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
    n = bk.bdpt_megakernel.launches
    got = bk.bdpt_megakernel(scene, ov, dv, ids, rng.prng_key(2), depth, uniforms=u, mis=mis)
    want = bk.bdpt_megakernel_plain(scene, ov, dv, ids, rng.prng_key(2), depth,
                                    uniforms=u, mis=mis)
    torch.cuda.synchronize()
    assert bk.bdpt_megakernel.launches == n + 1
    assert _frac_close(got, want) >= 0.999
    assert all(float(c[::13].abs().max()) == 0.0 for c in got[:3])
    for g, w in zip(_counters(got), _counters(want)):
        assert abs(g - w) <= 1e-3 * w


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
def test_bdpt_pixels_mode_matches_plain_with_exact_counters(mis):
    scene = _scene("cornell")
    W, S = 32, 4
    cc = camera_constants(dataclasses.replace(presets.cornell_box_camera(),
                                              image_width=W, samples_per_pixel=S * S),
                          torch.float32, "cuda")
    pix = torch.arange(W * W, device="cuda")
    i, j = (pix % W).float(), (pix // W).float()
    args = (scene, i, j, pix.int(), pk.camera_table(cc), rng.prng_key(0), 10, S)
    got = bk.bdpt_megakernel_pixels(*args, mis=mis)
    want = bk.bdpt_megakernel_pixels_plain(*args, mis=mis)
    torch.cuda.synchronize()
    assert _frac_close(got, want) >= 0.999
    assert _counters(got) == _counters(want)


def test_bdpt_depth80_matches_plain():
    """The glass north-star depth: 80 bounces a side, vertex scratch
    2 x 80 x 16 floats a lane, on the mixed scene with bdpt-mis."""
    scene = _scene("mixed")
    W, S = 16, 2
    cc = camera_constants(dataclasses.replace(presets.cornell_box_camera(),
                                              image_width=W, samples_per_pixel=S * S),
                          torch.float32, "cuda")
    pix = torch.arange(W * W, device="cuda")
    i, j = (pix % W).float(), (pix // W).float()
    args = (scene, i, j, pix, pk.camera_table(cc), rng.prng_key(1), 80, S)
    got = bk.bdpt_megakernel_pixels(*args, mis=True)
    want = bk.bdpt_megakernel_pixels_plain(*args, mis=True)
    torch.cuda.synchronize()
    assert _frac_close(got, want) >= 0.999
    assert _counters(got) == _counters(want)


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_render_bdpt_on_card_matches_cpu(integrator):
    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=16,
                              samples_per_pixel=4, max_depth=10, integrator=integrator)
    gpu = render(presets.cornell_box(device="cuda"), cfg, seed=3)
    cpu = render(presets.cornell_box(device="cpu"), cfg, seed=3)
    ok = np.isclose(gpu.framebuffer_sum, cpu.framebuffer_sum, rtol=1e-4, atol=1e-5)
    assert ok.all(axis=-1).mean() >= 0.97
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= 10
    assert abs(gpu.stats.shadow_rays - cpu.stats.shadow_rays) <= 0.01 * cpu.stats.shadow_rays


def test_bdpt_wrapper_rejects_what_the_kernel_cannot_take():
    scene = _scene("cornell")
    o = Vec3(*(torch.zeros(4, device="cuda") for _ in range(3)))
    ids = torch.arange(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="depth"):
        bk.bdpt_megakernel(scene, o, o, ids, rng.prng_key(0), bk.MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="expected"):
        bk.bdpt_megakernel(scene, o, o, torch.arange(5, device="cuda"), rng.prng_key(0), 2)
    with pytest.raises(ValueError, match="uniforms"):
        bk.bdpt_megakernel(scene, o, o, ids, rng.prng_key(0), 2,
                           uniforms=torch.zeros((3, 4), device="cuda"))


def _big_lanes(B, seed):
    o, d = (torch.from_numpy(x).cuda() for x in big_rays(B, seed))
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    ids[::13] = -1
    return Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), ids


def test_closest_bvh_matches_plain_exactly():
    scene = big_scene(builder, device="cuda")
    o, d, ids = _big_lanes(8192, 7)
    active = ids >= 0
    n = pw.closest_bvh.launches
    got = pw.closest_bvh(scene, o, d, active)
    want = pw.closest_bvh_plain(scene, o, d, active)
    torch.cuda.synchronize()
    assert pw.closest_bvh.launches == n + 1
    assert torch.equal(got[1], want[1]) and bool((got[1] >= 0).any())
    assert torch.equal(got[0], want[0])
    assert got[4].tolist() == want[4].tolist()
    assert bool((got[1][~active] == -1).all())


def test_any_bvh_matches_plain_exactly():
    """Every lane's answer and all four counters; one lane in eight dead."""
    scene = big_scene(builder, device="cuda")
    o, d, _ = _big_lanes(8192, 11)
    tmax = torch.from_numpy(np.random.default_rng(11).uniform(
        0.1, 6.0, 8192).astype(np.float32)).cuda()
    tmax[::8] = 0.0
    n = pw.any_bvh.launches
    got = pw.any_bvh(scene, o, d, tmax)
    want = pw.any_bvh_plain(scene, o, d, tmax)
    torch.cuda.synchronize()
    assert pw.any_bvh.launches == n + 1
    assert torch.equal(got[0], want[0]) and bool(got[0].any())
    assert not bool(got[0][::8].any())
    assert got[1].tolist() == want[1].tolist()


def test_megakernel_plain_versions_walk_in_torch():
    """A scene of 257-512 triangles has a BVH and takes the megakernels;
    their plain versions walk its BVH in torch and launch no BVH kernel."""
    from bpt_tpu_torch.ops import soa

    b = presets.cornell_box_builder()
    b.add_uv_sphere((278.0, 150.0, 278.0), 100.0, builder.MaterialSpec.lambertian(
        (0.7, 0.7, 0.7)), lat_steps=8, lon_steps=20)
    scene = b.build(device="cuda")
    assert 256 < scene.num_tris <= pk.MAX_TRIS and scene.use_bvh
    o, d = (torch.from_numpy(x).cuda() for x in rays(1024, 5))
    ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
    ids = torch.arange(1024, dtype=torch.int32, device="cuda")
    launched = pw.closest_bvh.launches + pw.any_bvh.launches
    walks = soa.bvh_closest.calls, soa.bvh_any.calls
    pk.pt_megakernel_plain(scene, ov, dv, ids, rng.prng_key(1), 3)
    bk.bdpt_megakernel_plain(scene, ov, dv, ids, rng.prng_key(1), 3)
    assert pw.closest_bvh.launches + pw.any_bvh.launches == launched
    assert soa.bvh_closest.calls > walks[0] and soa.bvh_any.calls > walks[1]


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_render_bdpt_wave_on_card_matches_cpu(integrator, monkeypatch):
    """The large-scene BDPT wave route (taken here under its 2^18 samples):
    7 closest_bvh and 4 any_bvh launches a wave at depth 4, no plain walk,
    no megakernel, and the CPU render's image."""
    from bpt_tpu_torch.models import render as rmod
    from bpt_tpu_torch.ops import soa

    monkeypatch.setattr(rmod, "WAVE_MIN_RAYS", 1)
    n_mk = bk.bdpt_megakernel.launches + bk.bdpt_megakernel_pixels.launches
    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=16,
                              samples_per_pixel=4, max_depth=4, integrator=integrator,
                              vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    nc, na = pw.closest_bvh.launches, pw.any_bvh.launches
    walks = soa.bvh_closest.calls + soa.bvh_any.calls
    gpu = render(big_scene(builder, device="cuda"), cfg, seed=3)
    assert (pw.closest_bvh.launches - nc, pw.any_bvh.launches - na) == (7, 4)
    assert soa.bvh_closest.calls + soa.bvh_any.calls == walks
    assert bk.bdpt_megakernel.launches + bk.bdpt_megakernel_pixels.launches == n_mk
    cpu = render(big_scene(builder, device="cpu"), cfg, seed=3)
    ok = np.isclose(gpu.framebuffer_sum, cpu.framebuffer_sum, rtol=1e-4, atol=1e-5)
    assert ok.all(axis=-1).mean() >= 0.99
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= 10
    assert abs(gpu.stats.shadow_rays - cpu.stats.shadow_rays) <= 0.01 * cpu.stats.shadow_rays
    assert gpu.stats.shadow_rays > 0


@pytest.mark.parametrize("paged", [False, True], ids=["walk", "paged"])
def test_pt_wave_matches_plain(paged):
    scene = big_scene(builder, device="cuda")
    o, d, ids = _big_lanes(8192, 8)
    n = pw.pt_wave_bounce.launches, pw.closest_bvh.launches
    got = pw.pt_wave(scene, o, d, ids, rng.prng_key(4), 6, paged=paged)
    want = pw.pt_wave_plain(scene, o, d, ids, rng.prng_key(4), 6, paged=paged)
    torch.cuda.synchronize()
    # each bounce: closest_bvh's walk, then the shade
    assert (pw.pt_wave_bounce.launches, pw.closest_bvh.launches) == (n[0] + 6, n[1] + 6)
    assert _frac_close(got, want) >= 0.999
    assert int(got[3]) == int(want[3])
    assert got[4].tolist() == want[4].tolist()


def test_pt_wave_bounce_state_matches_plain():
    """Every state row of one bounce; origin, direction and throughput on
    the lanes that stay alive (a dead lane's are never read again)."""
    scene = big_scene(builder, device="cuda")
    o, d, ids = _big_lanes(8192, 10)
    state = torch.zeros((pw.STATE_ROWS, 8192), device="cuda")
    state[pw.OX:pw.DX + 3] = torch.stack([*o, *d])
    state[pw.THR:pw.THR + 3] = 1.0
    state[pw.ALIVE] = (ids >= 0).float()
    got, gc = pw.pt_wave_bounce(scene, state, ids, rng.prng_key(5), 1)
    want, wc = pw.pt_wave_bounce_plain(scene, state, ids, rng.prng_key(5), 1)
    live = want[pw.ALIVE] > 0.5
    assert bool(live.any())
    got, want = (torch.cat([torch.where(live, x[:pw.RAD], 0.0), x[pw.RAD:]])
                 for x in (got, want))
    ok = torch.isclose(got, want, rtol=1e-4, atol=1e-6).all(dim=0)
    assert float(ok.double().mean()) >= 0.999
    assert gc.tolist() == wc.tolist()


def test_render_wave_on_card_matches_cpu():
    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=16,
                              samples_per_pixel=4, max_depth=6, integrator="pt",
                              vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    n = pw.pt_wave_bounce.launches
    gpu = render(big_scene(builder, device="cuda"), cfg, seed=3)
    assert pw.pt_wave_bounce.launches > n
    cpu = render(big_scene(builder, device="cpu"), cfg, seed=3)
    ok = np.isclose(gpu.framebuffer_sum, cpu.framebuffer_sum, rtol=1e-4, atol=1e-6)
    assert ok.all(axis=-1).mean() >= 0.99
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= 10


def test_wave_wrappers_reject_what_the_kernels_cannot_take():
    scene = big_scene(builder, device="cuda")
    o, d, ids = _big_lanes(64, 9)
    with pytest.raises(ValueError, match="expected"):
        pw.closest_bvh(scene, o, d, (ids >= 0)[:32])
    tmax = torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="expected"):
        pw.any_bvh(scene, o, d, tmax[:32])
    with pytest.raises(ValueError, match="expected"):
        pw.any_bvh(scene, o, d, tmax.double())
    with pytest.raises(ValueError, match="interval"):  # float32 takes T_MIN only
        pw.any_bvh(scene, o, d, tmax, tmin=0.0)
    scene64 = big_scene(builder, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="expected torch.float64"):  # f32 rays, f64 scene
        pw.any_bvh(scene64, o, d, tmax.double())
    state = torch.zeros((pw.STATE_ROWS, 64), device="cuda")
    with pytest.raises(ValueError, match="float32"):  # the shade takes float32 only
        pw.pt_wave_bounce(scene64, state, ids, rng.prng_key(0), 0)
    with pytest.raises(ValueError, match="expected"):
        pw.pt_wave_bounce(scene, state, ids[:32], rng.prng_key(0), 0)
    with pytest.raises(ValueError, match="float32"):
        pw.pt_wave(big_scene(builder, device="cuda", dtype=torch.float64), o, d, ids,
                   rng.prng_key(0), 2)


def tri_soup(n, seed, device="cuda", dtype=torch.float32):
    """n random triangles in the cornell box's bounds under one quad light
    of the box's size: n + 2 triangles, no BVH up to 254 (256 in all)."""
    g = np.random.default_rng(seed)
    b = builder.SceneBuilder()
    white = builder.MaterialSpec.lambertian((0.7, 0.7, 0.7))
    for _ in range(n):
        p = g.uniform(0, 555, 3)
        b.add_triangle(tuple(p), tuple(p + g.normal(0, 60, 3)), tuple(p + g.normal(0, 60, 3)),
                       white)
    b.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555),
               builder.MaterialSpec.diffuse_light((4, 4, 4)))
    return b.build(device=device, dtype=dtype)


def _tri_lanes(B, seed, dtype):
    """Random rays with per-lane [tmin, tmax]; one lane in five dead
    (tmax < tmin), one in seven to inf."""
    o, d = (torch.from_numpy(x).to("cuda", dtype) for x in rays(B, seed))
    g = np.random.default_rng(seed)
    tmin = torch.from_numpy(g.uniform(0.0, 50.0, B)).to("cuda", dtype)
    tmax = tmin + torch.from_numpy(g.uniform(-200.0, 900.0, B)).to("cuda", dtype)
    tmax[::7] = torch.inf
    return Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), tmin, tmax


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tri_kernels_match_plain(dtype):
    """closest_tri / any_tri against brute_closest / brute_any on the
    cornell box and a 256-triangle soup: hit, triangle and any-answer
    exact, t, u, v within 1e-6 (exact expected: both round every
    operation)."""
    from bpt_tpu_torch.ops.kernels import intersect as ki

    for scene in (presets.cornell_box(device="cuda", dtype=dtype), tri_soup(254, 3, dtype=dtype)):
        assert not scene.use_bvh
        o, d, tmin, tmax = _tri_lanes(10_007, 4, dtype)
        n = ki.closest_tri.launches, ki.any_tri.launches
        got = ki.closest_tri(scene, o, d, tmin, tmax)
        want = ki.closest_tri_plain(scene, o, d, tmin, tmax)
        hit_k = ki.any_tri(scene, o, d, tmin, tmax)
        hit_p = ki.any_tri_plain(scene, o, d, tmin, tmax)
        torch.cuda.synchronize()
        assert (ki.closest_tri.launches, ki.any_tri.launches) == (n[0] + 1, n[1] + 1)
        assert torch.equal(got[1], want[1]) and 0.2 < float((got[1] >= 0).double().mean()) < 0.95
        hit = got[1] >= 0
        assert torch.equal(got[0][~hit], want[0][~hit]) and bool(got[0][~hit].isinf().all())
        for g_, w_ in zip(got[0:1] + got[2:], want[0:1] + want[2:]):
            assert g_.dtype == dtype and float((g_ - w_)[hit].abs().max()) <= 1e-6
        assert torch.equal(hit_k, hit_p) and not bool(hit_k[tmax < tmin].any())


def _tri_case(case, dtype):
    """Lanes of one case of the brute-force hit kernels' persistent grid,
    on the card: a shadow wave's layout (torch_parity.shadow_wave: 10 light
    rows of 4,096 lanes, sparser row by row, runs of dead lanes, masked and
    NaN lanes), ragged B, every lane dead, every lane live."""
    if case == "shadow wave":
        o, d, tmin, tmax, _ = shadow_wave(10, 4096, 21)
    else:
        B = {"B=1": 1, "B=31": 31, "B=33": 33, "B=129": 129}.get(case, 70_001)
        o, d = rays(B, 7)
        g = np.random.default_rng(7)
        tmin = g.uniform(0.0, 50.0, B)
        tmax = tmin + g.uniform(10.0, 900.0, B)
        if case == "all dead":
            tmax = tmin - 1.0
            tmax[::5] = np.nan
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dtype)  # noqa: E731
    return (Vec3(*(to(o[:, k]) for k in range(3))), Vec3(*(to(d[:, k]) for k in range(3))),
            to(tmin), to(tmax))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["shadow wave", "B=1", "B=31", "B=33", "B=129", "all dead",
                                  "all live"])
def test_tri_kernels_persistent_grid_match_plain(case, dtype):
    """closest_tri / any_tri on their persistent grid, whose warps hold live
    rays only, against brute_closest / brute_any: hit, triangle and
    any-answer exact, t, u, v within 1e-6, a dead lane's miss (t = inf, tri
    -1, u = v = 0, no hit); two launches in a row equal to the bit."""
    from bpt_tpu_torch.ops.kernels import intersect as ki

    scene = presets.cornell_box(device="cuda", dtype=dtype)
    o, d, tmin, tmax = _tri_case(case, dtype)
    n = ki.closest_tri.launches, ki.any_tri.launches
    got, again = (ki.closest_tri(scene, o, d, tmin, tmax) for _ in range(2))
    hit_k, hit_k2 = (ki.any_tri(scene, o, d, tmin, tmax) for _ in range(2))
    want = ki.closest_tri_plain(scene, o, d, tmin, tmax)
    hit_p = ki.any_tri_plain(scene, o, d, tmin, tmax)
    torch.cuda.synchronize()
    assert (ki.closest_tri.launches, ki.any_tri.launches) == (n[0] + 2, n[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(hit_k, hit_k2)
    assert torch.equal(got[1], want[1]) and torch.equal(hit_k, hit_p)
    hit, live = got[1] >= 0, tmin <= tmax
    assert torch.equal(got[0][~hit], want[0][~hit]) and bool(got[0][~hit].isinf().all())
    assert not bool(got[2][~hit].any() or got[3][~hit].any())
    for g_, w_ in zip(got[0:1] + got[2:], want[0:1] + want[2:]):
        err = (g_ - w_)[hit].abs()
        assert g_.dtype == dtype and (err.numel() == 0 or float(err.max()) <= 1e-6)
    assert not bool(hit[~live].any() or hit_k[~live].any())
    if case == "all dead":
        assert not bool(live.any())
    elif case == "all live":
        assert bool(live.all()) and 0.2 < float(hit.double().mean()) < 1.0
    elif case == "shadow wave":
        rows = live.view(10, 4096).sum(dim=1)
        assert int(rows[0]) > 3 * int(rows[-1]) > 0 and bool(hit_k.any())


def test_tri_wrappers_reject_what_the_kernels_cannot_take():
    from bpt_tpu_torch.ops.kernels import intersect as ki

    scene = presets.cornell_box(device="cuda")
    o, d, tmin, tmax = _tri_lanes(64, 1, torch.float32)
    with pytest.raises(ValueError, match="expected"):
        ki.closest_tri(scene, o, d, tmin[:32], tmax[:32])
    with pytest.raises(ValueError, match="expected"):
        ki.any_tri(scene, o, d, tmin, tmax.double())
    with pytest.raises(ValueError, match="float32 or float64"):
        ki.any_tri(dataclasses.replace(scene, v0=scene.v0.half()), o, d, tmin, tmax)


def test_render_ref_vis_on_card_matches_cpu():
    """The ref_vis BDPT render (the stratum loop over closest_tri /
    any_tri: 2 * depth - 1 and depth launches a wave, no plain call) at
    32x32, 16 spp, depth 10, against the same render on the CPU: rays
    within 0.1%; shadow rays and the image's mean within 3%, since a tie at
    a connection's endpoint resolves on the last ulp of a hit point."""
    from bpt_tpu_torch.ops.kernels import intersect as ki

    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=32,
                              samples_per_pixel=16, max_depth=10, integrator="bdpt",
                              ref_vis=True)
    n = ki.closest_tri.launches, ki.any_tri.launches
    calls = ki.closest_tri_plain.calls + ki.any_tri_plain.calls
    gpu = render(presets.cornell_box(device="cuda"), cfg, seed=3)
    assert (ki.closest_tri.launches - n[0], ki.any_tri.launches - n[1]) == (19, 10)
    assert ki.closest_tri_plain.calls + ki.any_tri_plain.calls == calls
    cpu = render(presets.cornell_box(device="cpu"), cfg, seed=3)
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= 1e-3 * cpu.stats.rays_traced
    assert abs(gpu.stats.shadow_rays / cpu.stats.shadow_rays - 1) <= 0.03
    assert abs(gpu.framebuffer_sum.mean() / cpu.framebuffer_sum.mean() - 1) <= 0.03


@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
def test_defocus_render_launches_only_rays_mode(integrator):
    """Defocus on the cornell box takes the stratum loop: one rays-mode
    megakernel launch a wave (jnp raygen first), no pixels-mode launch, no
    hit kernel and no plain version; the image equals the route's plain
    twin on the card (plain=True)."""
    from bpt_tpu_torch.models.render import _render_strata
    from bpt_tpu_torch.ops.kernels import intersect as ki

    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=16,
                              samples_per_pixel=4, max_depth=4, integrator=integrator,
                              defocus_angle=1.0, focus_dist=1078.0)
    mk = pk.pt_megakernel if integrator == "pt" else bk.bdpt_megakernel
    others = (pk.pt_megakernel_pixels, bk.bdpt_megakernel_pixels, ki.closest_tri, ki.any_tri,
              pk.pt_megakernel if integrator != "pt" else bk.bdpt_megakernel)
    plains = (pk.pt_megakernel_plain, bk.bdpt_megakernel_plain)
    n, n_other = mk.launches, sum(f.launches for f in others)
    n_plain = sum(f.calls for f in plains)
    scene = presets.cornell_box(device="cuda")
    res = render(scene, cfg, seed=2)
    assert mk.launches == n + 1 and sum(f.launches for f in others) == n_other
    assert sum(f.calls for f in plains) == n_plain
    fb = torch.zeros((16 * 16, 3), device="cuda")
    _render_strata(scene, cfg, camera_constants(cfg, torch.float32, "cuda"), integrator, 2, fb,
                   None, None, None, plain=True)
    assert sum(f.calls for f in plains) == n_plain + 1
    ok = np.isclose(res.framebuffer_sum, fb.cpu().numpy().reshape(16, 16, 3), rtol=1e-4,
                    atol=1e-5)
    assert ok.all(axis=-1).mean() >= 0.99 and res.framebuffer_sum.mean() > 0


# ------------------------------------------- the megakernels' walk mode


def _walk_counters(out):
    """(rays, shadow rays, node visits, box hits, tri tests, tri hits) of
    a PT (shadow 0) or BDPT megakernel's outputs."""
    if len(out) == 5:
        return [int(out[3]), 0] + [int(x) for x in out[4]]
    return _counters(out)


@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
@pytest.mark.parametrize("injected", [True, False], ids=["buffer", "rng"])
def test_walk_rays_mode_matches_plain(integrator, injected):
    """The walk mode on the 964-triangle scene: radiance on >= 99.9% of
    lanes, rays, shadow rays and the four walk counters exact."""
    scene = big_scene(builder, device="cuda")
    B, depth = 8192, 6
    o, d, ids = _big_lanes(B, 12)
    slots = depth * NU if integrator == "pt" else bk.n_uniform_slots(depth)
    u = (torch.from_numpy(np.random.default_rng(13).uniform(size=(slots, B))
                          .astype(np.float32)).cuda() if injected else None)
    a = (scene, o, d, ids, rng.prng_key(3), depth)
    if integrator == "pt":
        n = pk.pt_megakernel.launches
        got = pk.pt_megakernel(*a, uniforms=u)
        want = pk.pt_megakernel_plain(*a, uniforms=u)
        launched = pk.pt_megakernel.launches - n
    else:
        n = bk.bdpt_megakernel.launches
        got = bk.bdpt_megakernel(*a, uniforms=u, mis=integrator == "bdpt-mis")
        want = bk.bdpt_megakernel_plain(*a, uniforms=u, mis=integrator == "bdpt-mis")
        launched = bk.bdpt_megakernel.launches - n
    torch.cuda.synchronize()
    assert launched == 1
    assert _frac_close(got, want) >= 0.999
    assert all(float(c[::13].abs().max()) == 0.0 for c in got[:3])
    kc = _walk_counters(got)
    assert kc == _walk_counters(want) and kc[2] > kc[3] > 0


@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
def test_walk_pixels_mode_matches_plain(integrator):
    scene = big_scene(builder, device="cuda")
    W, S, depth = 32, 2, 10
    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                              samples_per_pixel=S * S, vfov=40.0, lookfrom=(0.0, 2.0, 6.0),
                              lookat=(0.0, 1.0, 0.0))
    cam = pk.camera_table(camera_constants(cfg, torch.float32, "cuda"))
    pix = torch.arange(W * W, device="cuda")
    i, j = (pix % W).float(), (pix // W).float()
    if integrator == "pt":
        a = (scene, i, j, i * 0, j * 0, pix.int(), cam, rng.prng_key(0), depth)
        got = pk.pt_megakernel_pixels(*a, spp_loop=S * S, sqrt_spp=S)
        want = pk.pt_megakernel_pixels_plain(*a, spp_loop=S * S, sqrt_spp=S)
    else:
        a = (scene, i, j, pix.int(), cam, rng.prng_key(0), depth, S)
        got = bk.bdpt_megakernel_pixels(*a, mis=integrator == "bdpt-mis")
        want = bk.bdpt_megakernel_pixels_plain(*a, mis=integrator == "bdpt-mis")
    torch.cuda.synchronize()
    assert _frac_close(got, want) >= 0.999
    assert _walk_counters(got) == _walk_counters(want)


def test_walk_depth80_matches_plain():
    scene = big_scene(builder, device="cuda")
    W, S = 8, 2
    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                              samples_per_pixel=S * S, vfov=40.0, lookfrom=(0.0, 2.0, 6.0),
                              lookat=(0.0, 1.0, 0.0))
    pix = torch.arange(W * W, device="cuda")
    i, j = (pix % W).float(), (pix // W).float()
    a = (scene, i, j, pix, pk.camera_table(camera_constants(cfg, torch.float32, "cuda")),
         rng.prng_key(1), 80, S)
    got = bk.bdpt_megakernel_pixels(*a, mis=True)
    want = bk.bdpt_megakernel_pixels_plain(*a, mis=True)
    torch.cuda.synchronize()
    assert _frac_close(got, want) >= 0.999
    assert _walk_counters(got) == _walk_counters(want)


@pytest.mark.parametrize("case, integrator", [
    ("ranges", "pt"), ("ranges", "bdpt"), ("ranges", "bdpt-mis"),
    ("B37", "pt"), ("B37", "bdpt"), ("B37", "bdpt-mis"),
    ("inactive", "pt"), ("inactive", "bdpt-mis"),
    ("depth80", "pt"), ("depth80", "bdpt-mis"),
])
def test_walk_schedule_matches_plain(case, integrator, monkeypatch):
    """The walk kernels' persistent schedule against the plain versions on
    the 964-triangle scene, counters exact: pixels mode with a budget of
    one stratum a launch (4 stratum ranges, 4 launches); rays mode at
    B = 37, under one block of the persistent grid; pixels mode with
    inactive lanes (rid < 0) between live ones; pixels mode at depth 80."""
    scene = big_scene(builder, device="cuda")
    key, mis, pt = rng.prng_key(4), integrator == "bdpt-mis", integrator == "pt"
    if case == "B37":
        o, d, ids = _big_lanes(37, 21)
        a = (scene, o, d, ids, key, 10)
        mk = pk.pt_megakernel if pt else bk.bdpt_megakernel
        n = mk.launches
        got = mk(*a) if pt else mk(*a, mis=mis)
        want = pk.pt_megakernel_plain(*a) if pt else bk.bdpt_megakernel_plain(*a, mis=mis)
        live, launches = ids >= 0, 1
    else:
        W, S, depth = (8, 2, 80) if case == "depth80" else (16, 2, 10)
        cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                                  samples_per_pixel=S * S, vfov=40.0,
                                  lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
        cam = pk.camera_table(camera_constants(cfg, torch.float32, "cuda"))
        pix = torch.arange(W * W, dtype=torch.int32, device="cuda")
        i, j = (pix % W).float(), (pix // W).float()
        if case == "inactive":
            pix[1::3] = -1
        launches = 1
        if case == "ranges":
            monkeypatch.setattr(pk, "STRATA_BYTES", 12 * W * W)
            launches = S * S
        live = pix >= 0
        if pt:
            a = (scene, i, j, i * 0, j * 0, pix, cam, key, depth)
            kw = dict(spp_loop=S * S, sqrt_spp=S)
            mk, plain = pk.pt_megakernel_pixels, pk.pt_megakernel_pixels_plain
        else:
            a = (scene, i, j, pix, cam, key, depth, S)
            kw = dict(mis=mis)
            mk, plain = bk.bdpt_megakernel_pixels, bk.bdpt_megakernel_pixels_plain
        n = mk.launches
        got = mk(*a, **kw)
        want = plain(*a, **kw)
    torch.cuda.synchronize()
    assert mk.launches - n == launches
    assert _frac_close(got, want) >= 0.999
    assert all(float(c[~live].abs().sum()) == 0.0 for c in got[:3])
    kc = _walk_counters(got)
    assert kc == _walk_counters(want) and kc[2] > kc[3] > 0


@pytest.mark.parametrize("integrator", ["pt", "bdpt-mis"])
def test_render_fused_walk_on_card_matches_cpu(integrator, monkeypatch):
    """Under 2^18 samples large-scene BDPT takes the fused loop: one
    pixels-mode launch, no BVH hit kernel, no plain version, and the CPU
    render's image and counters.  render() sends large-scene PT to
    pt_wave at every size; its fused loop is held here by taking that
    route by hand."""
    from bpt_tpu_torch.models import render as rmod
    from bpt_tpu_torch.ops import soa

    if integrator == "pt":
        monkeypatch.setattr(rmod, "_route", lambda *args: "fused")

    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=16,
                              samples_per_pixel=4, max_depth=6, integrator=integrator,
                              vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    mk = pk.pt_megakernel_pixels if integrator == "pt" else bk.bdpt_megakernel_pixels
    n, hits = mk.launches, pw.closest_bvh.launches + pw.any_bvh.launches
    walks = soa.bvh_closest.calls + soa.bvh_any.calls
    gpu = render(big_scene(builder, device="cuda"), cfg, seed=3)
    assert mk.launches == n + 1
    assert pw.closest_bvh.launches + pw.any_bvh.launches == hits
    assert soa.bvh_closest.calls + soa.bvh_any.calls == walks
    cpu = render(big_scene(builder, device="cpu"), cfg, seed=3)
    ok = np.isclose(gpu.framebuffer_sum, cpu.framebuffer_sum, rtol=1e-4, atol=1e-5)
    assert ok.all(axis=-1).mean() >= 0.99
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= 10
    assert abs(gpu.stats.shadow_rays - cpu.stats.shadow_rays) <= 0.01 * max(1, cpu.stats.shadow_rays)


def _interval_lanes(B, seed):
    """big_rays with per-lane [tmin, tmax]: tmin above T_MIN on a third of
    the lanes, tmax finite on most, one lane in nine dead (tmax <= 0)."""
    from bpt_tpu_torch.ops.intersect import T_MIN

    o, d, _ = _big_lanes(B, seed)
    g = np.random.default_rng(seed)
    tmin = np.where(g.uniform(size=B) < 0.3, g.uniform(0.3, 1.0, B), T_MIN).astype(np.float32)
    tmax = g.uniform(0.5, 6.0, B).astype(np.float32)
    tmax[::5] = np.inf
    tmax[::9] = 0.0
    return o, d, torch.from_numpy(tmin).cuda(), torch.from_numpy(tmax).cuda()


def _clustered_fns(impl):
    from bpt_tpu_torch.ops.kernels import cluster_wave as cw
    from bpt_tpu_torch.ops.kernels import plucker as kp

    return {"roll": (cw.clustered_closest, cw.clustered_closest_plain,
                     cw.clustered_any, cw.clustered_any_plain),
            "plucker": (kp.plucker_closest, kp.plucker_closest_plain,
                        kp.plucker_any, kp.plucker_any_plain)}[impl]


@pytest.mark.parametrize("impl", ["roll", "plucker"])
def test_clustered_kernels_match_plain_bitwise(impl):
    """The rolled (Pallas kernels 10-11) and Plücker (12-13) clustered
    kernels against their plain versions over per-lane intervals: hit,
    triangle and any-answer exact, t, u, v to the bit, counters exact."""
    scene = big_scene(builder, device="cuda")
    o, d, tmin, tmax = _interval_lanes(8193, 13)
    closest, closest_plain, any_, any_plain = _clustered_fns(impl)
    n = (closest.launches, any_.launches)
    got = closest(scene, o, d, tmin, tmax)
    want = closest_plain(scene, o, d, tmin, tmax)
    hit_k, c_k = any_(scene, o, d, tmin, tmax)
    hit_p, c_p = any_plain(scene, o, d, tmin, tmax)
    torch.cuda.synchronize()
    assert (closest.launches, any_.launches) == (n[0] + 1, n[1] + 1)
    assert torch.equal(got[1], want[1]) and bool((got[1] >= 0).any())
    for k, p in zip(got[:4], want[:4]):
        bad = (k != p) & ~(k.isnan() & p.isnan())
        assert not bool(bad.any()), (f"lane {int(bad.nonzero()[0])}: kernel "
                                     f"{[float(x[bad][0]) for x in got[:4]]}")
    assert got[4].tolist() == want[4].tolist()
    assert torch.equal(hit_k, hit_p) and bool(hit_k.any()) and not bool(hit_k[::9].any())
    assert c_k.tolist() == c_p.tolist()


@pytest.mark.parametrize("switch", ["", "BPT_TPU_NO_FTB", "BPT_TPU_WAVE_IMPL"])
def test_clustered_dispatch_on_card_matches_plain(switch, monkeypatch):
    """ops.soa.closest_hit / any_hit on a card scene with a BVH: a general
    interval (no switch) or the production one under a switch launches the
    clustered kernels, raises nothing, and equals plain=True."""
    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.ops.intersect import T_MIN

    scene = big_scene(builder, device="cuda")
    o, d, tmin, tmax = _interval_lanes(4097, 17)
    mask = tmax > 0.0
    if switch:
        monkeypatch.setenv(switch, "plucker" if switch == "BPT_TPU_WAVE_IMPL" else "1")
        tmin, tmax = T_MIN, float("inf")
    closest, closest_plain, any_, any_plain = _clustered_fns(
        "plucker" if switch == "BPT_TPU_WAVE_IMPL" else "roll")
    n = (closest.launches, any_.launches, closest_plain.calls, any_plain.calls)
    walks = (pw.closest_bvh.launches, pw.any_bvh.launches)
    got = soa.closest_hit(scene, o, d, tmin, tmax, mask=mask)
    hit = soa.any_hit(scene, o, d, tmin, tmax, mask=mask)
    assert (closest.launches, any_.launches) == (n[0] + 1, n[1] + 1)
    want = soa.closest_hit(scene, o, d, tmin, tmax, mask=mask, plain=True)
    hit_p = soa.any_hit(scene, o, d, tmin, tmax, mask=mask, plain=True)
    torch.cuda.synchronize()
    assert (closest_plain.calls, any_plain.calls) == (n[2] + 1, n[3] + 1)
    assert (pw.closest_bvh.launches, pw.any_bvh.launches) == walks
    for k, p in zip(got, want):
        assert torch.equal(k, p)
    assert torch.equal(hit, hit_p) and bool(got.hit.any()) and not bool(got.hit[~mask].any())


# ---- the warp-wide clustered hits: edge cases, to the bit

EDGE_CASES = ["B=1", "B=31", "B=37", "all dead", "one live lane a warp", "duplicated triangles",
              "zero direction on a box plane", "tmin below T_MIN", "tmax = inf", "t overflows"]
# "roll" and "plucker": the closest hits; "roll any", "plucker any": the any hits
EDGE_IMPLS = ["roll", "plucker", "roll any", "plucker any"]


def _edge_fns(impl):
    fns = _clustered_fns(impl.split()[0])
    return fns[2:] if impl.endswith("any") else fns[:2]


@pytest.fixture(scope="module")
def edge_lanes():
    """chip_smoke.py's edge cases of the clustered hits on big_scene (the
    duplicated sphere for the ties), seed 19."""
    import chip_smoke

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return chip_smoke.cluster_edge_lanes(big_scene(builder, device="cuda"),
                                         chip_smoke.dup_scene("cuda"), seed=19)


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("impl", EDGE_IMPLS)
def test_clustered_closest_edge_cases_bitwise(impl, case, edge_lanes):
    """The warp-wide clustered_closest / plucker_closest (and
    clustered_any / plucker_any) against their plain versions: t, tri, u, v
    (the any answer) to the bit, counters exact."""
    from chip_smoke import bits_differ

    kern, plain = _edge_fns(impl)
    scene, o, d, tmin, tmax = edge_lanes[case]
    n = kern.launches
    got = kern(scene, o, d, tmin, tmax)
    want = plain(scene, o, d, tmin, tmax)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    assert not bool(bits_differ(got[:-1], want[:-1]).any())
    assert got[-1].tolist() == want[-1].tolist()
    hits = got[0] if impl.endswith("any") else got[1] >= 0
    if case == "all dead":
        assert got[-1].tolist() == [0, 0, 0, 0] and not bool(hits.any())
    elif case != "B=1":
        assert bool(hits.any())
    if case == "t overflows" and impl == "plucker any":
        assert not bool(hits[0])  # its t is +inf: no hit


@pytest.mark.parametrize("impl", EDGE_IMPLS)
def test_clustered_closest_matches_its_strided_launches(impl, edge_lanes):
    """A whole launch equals, on every 3rd and every 7th lane, its launches
    on those lanes alone: a lane's answer does not depend on its warp."""
    from chip_smoke import bits_differ

    kern = _edge_fns(impl)[0]
    scene, o, d, tmin, tmax = edge_lanes["tmin below T_MIN"]
    full = kern(scene, o, d, tmin, tmax)
    for s in (3, 7):
        sl = torch.arange(0, tmax.numel(), s, device="cuda")
        sub = kern(scene, Vec3(*(x[sl] for x in o)), Vec3(*(x[sl] for x in d)), tmin[sl],
                   tmax[sl])
        assert not bool(bits_differ([x[sl] for x in full[:-1]], sub[:-1]).any())


# ---- the refilling wave kernels: closest_bvh and pt_wave_bounce on a
# persistent grid whose warps take new lanes as old ones finish

REFILL_CASES = ["B=1", "B=31", "B=37", "several refills", "all inactive", "scattered"]


def _refill_lanes(case, seed):
    """(o, d, active) of a refill edge case on big_scene: a lane in 13 dead;
    "several refills" holds 4 x the resident grid's threads and 5 more,
    "all inactive" no live lane, "scattered" one live lane in ten at
    random places among 65,536, its rays in random order."""
    from bpt_tpu_torch.ops.kernels import build

    if case.startswith("B="):
        B = int(case[2:])
    elif case == "several refills":
        B = 4 * build.load_library().bpt_wave_blocks() * 128 + 5
    else:
        B = 65536 if case == "scattered" else 4096
    o, d, _ = _big_lanes(B, seed)
    g = np.random.default_rng(seed)
    if case == "scattered":
        perm = torch.from_numpy(g.permutation(B)).cuda()
        o, d = (Vec3(*(c[perm] for c in v)) for v in (o, d))
        active = torch.from_numpy(g.uniform(size=B) < 0.1).cuda()
    else:
        active = torch.arange(B, device="cuda") % 13 != 5
    if case == "all inactive":
        active[:] = False
    return o, d, active


@pytest.mark.parametrize("case", REFILL_CASES)
def test_closest_bvh_refill_matches_plain_bitwise(case):
    """t, tri, u, v to the bit and all four counters, whatever the lanes'
    count and liveness; an inactive lane misses."""
    scene = big_scene(builder, device="cuda")
    o, d, active = _refill_lanes(case, 21)
    got = pw.closest_bvh(scene, o, d, active)
    want = pw.closest_bvh_plain(scene, o, d, active)
    torch.cuda.synchronize()
    for k, p in zip(got[:4], want[:4]):
        assert torch.equal(k, p)
    assert got[4].tolist() == want[4].tolist()
    assert bool((got[1][~active] == -1).all()) and bool(got[0][~active].isinf().all())
    if int(active.sum()) > 1000:
        assert bool((got[1] >= 0).any())


@pytest.mark.parametrize("paged", [False, True], ids=["walk", "paged"])
@pytest.mark.parametrize("case", REFILL_CASES)
def test_pt_wave_bounce_refill_matches_plain(case, paged):
    """All five counters exact; a dead lane's rows copied to the bit (alive
    0); the live lanes' rows to the bit those of the same lanes launched
    alone, packed together (the schedule changes no bit), and within the
    shade's tolerance of the plain version (origin, direction and
    throughput on the lanes that stay alive)."""
    scene = big_scene(builder, device="cuda")
    o, d, active = _refill_lanes(case, 23)
    B = int(active.shape[0])
    state = torch.zeros((pw.STATE_ROWS, B), device="cuda")
    state[pw.OX:pw.DX + 3] = torch.stack([*o, *d])
    state[pw.THR:pw.THR + 3] = 0.5
    state[pw.RAD:pw.RAD + 3] = 0.25
    state[pw.ALIVE] = active.float()
    rid = torch.arange(B, dtype=torch.int32, device="cuda")
    key = rng.prng_key(6)
    hits = pw.closest_bvh(scene, o, d, active)[:2] if paged else None
    got, gc = pw.pt_wave_bounce(scene, state, rid, key, 2, hits)
    want, wc = pw.pt_wave_bounce_plain(scene, state, rid, key, 2, hits)
    live = active.nonzero()[:, 0]
    packed = pw.pt_wave_bounce(scene, state[:, live].contiguous(), rid[live], key, 2,
                               None if hits is None else tuple(h[live] for h in hits))[0]
    torch.cuda.synchronize()
    assert gc.tolist() == wc.tolist() and int(gc[0]) == live.numel()
    assert torch.equal(got[:pw.ALIVE, ~active], state[:pw.ALIVE, ~active])
    assert not bool(got[pw.ALIVE, ~active].any())
    assert torch.equal(got[:, live], packed)
    keep = want[pw.ALIVE] > 0.5
    got, want = (torch.cat([torch.where(keep, x[:pw.RAD], 0.0), x[pw.RAD:]])
                 for x in (got, want))
    ok = torch.isclose(got, want, rtol=1e-4, atol=1e-6).all(dim=0)
    assert float(ok.double().mean()) >= 0.999


# ---- the brute-force BDPT kernel on its persistent grid, and any_bvh's
# refilling grid, at the shapes that exercise the schedule

BRUTE_CASES = ["B=1", "B=31", "B=37", "past 4 grids", "all inactive", "scattered"]


def _cornell_lanes(case, seed, blocks="bpt_bdpt_blocks"):
    """(o, d, ids) of a brute-force edge case: the cornell camera's rays
    through random points of a 512x512 image; a lane in 13 inactive, "past
    4 grids" 4 x the threads of the persistent grid ``blocks`` (the
    library's occupancy query, brute mode without volumes) and 5 more, "all inactive" no live lane,
    "scattered" one live lane in ten at random places; 4096 lanes where the
    name gives no count."""
    from bpt_tpu_torch.models.camera import generate_rays
    from bpt_tpu_torch.ops.kernels import build

    if case.startswith("B="):
        B = int(case[2:])
    elif case == "past 4 grids":
        B = 4 * getattr(build.load_library(), blocks)(0, 0) * 128 + 5
    else:
        B = 4096
    g = np.random.default_rng(seed)
    cc = camera_constants(dataclasses.replace(presets.cornell_box_camera(), image_width=512),
                          torch.float32, "cuda")
    px = torch.from_numpy(g.integers(0, 512, (2, B)).astype(np.float32)).cuda()
    u = torch.from_numpy(g.uniform(size=(B, 4)).astype(np.float32)).cuda()
    o, d = generate_rays(cc, px[0], px[1], px[0] * 0, px[1] * 0, u)
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    if case == "scattered":
        ids = torch.where(torch.from_numpy(g.uniform(size=B) < 0.1).cuda(), ids, -1)
    else:
        ids[5::13] = -1
    if case == "all inactive":
        ids[:] = -1
    return Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), ids


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
@pytest.mark.parametrize("case", BRUTE_CASES)
def test_brute_bdpt_schedule_matches_plain(case, mis):
    """Rays mode at depth 10: radiance on >= 99.9% of lanes, all six
    counters exact, inactive lanes 0, and each live lane's radiance to the
    bit that of the same lanes launched alone, packed (the schedule changes
    no bit)."""
    scene = presets.cornell_box(device="cuda")
    o, d, ids = _cornell_lanes(case, 31)
    key = rng.prng_key(7)
    n = bk.bdpt_megakernel.launches
    got = bk.bdpt_megakernel(scene, o, d, ids, key, 10, mis=mis)
    want = bk.bdpt_megakernel_plain(scene, o, d, ids, key, 10, mis=mis)
    live = ids >= 0
    packed = bk.bdpt_megakernel(scene, Vec3(*(x[live] for x in o)), Vec3(*(x[live] for x in d)),
                                ids[live], key, 10, mis=mis)
    torch.cuda.synchronize()
    assert bk.bdpt_megakernel.launches == n + 2
    assert _frac_close(got, want) >= 0.999
    assert _counters(got) == _counters(want)
    assert all(float(c[~live].abs().sum()) == 0.0 for c in got[:3])
    assert all(torch.equal(c[live], pc) for c, pc in zip(got[:3], packed[:3]))
    assert _counters(packed) == _counters(got)
    if int(live.sum()) > 100:
        assert _counters(got)[1] > 0


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
@pytest.mark.parametrize("case", ["depth 1", "depth 80", "injected", "ranges"])
def test_brute_bdpt_modes_match_plain(case, mis, monkeypatch):
    """Pixels mode at depth 1 (cornell) and 80 (the mixed scene), rays mode
    with injected uniforms, and pixels mode over 4 stratum ranges (4
    launches, a budget of one stratum each): radiance on >= 99.9% of
    lanes, all six counters exact."""
    scene = _scene("mixed" if case == "depth 80" else "cornell")
    key = rng.prng_key(8)
    if case == "injected":
        o, d, ids = _cornell_lanes("injected", 9)
        u = torch.from_numpy(np.random.default_rng(10).uniform(
            size=(bk.n_uniform_slots(10), ids.numel())).astype(np.float32)).cuda()
        a, kw = (scene, o, d, ids, key, 10), dict(uniforms=u, mis=mis)
        mk, plain, launches = bk.bdpt_megakernel, bk.bdpt_megakernel_plain, 1
    else:
        W, S = 16, 2
        depth = {"depth 1": 1, "depth 80": 80}.get(case, 10)
        cc = camera_constants(dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                                                  samples_per_pixel=S * S),
                              torch.float32, "cuda")
        pix = torch.arange(W * W, dtype=torch.int32, device="cuda")
        pix[3::7] = -1
        i, j = (pix.clamp_min(0) % W).float(), (pix.clamp_min(0) // W).float()
        launches = 1
        if case == "ranges":
            monkeypatch.setattr(pk, "STRATA_BYTES", 12 * W * W)
            launches = S * S
        a, kw = (scene, i, j, pix, pk.camera_table(cc), key, depth, S), dict(mis=mis)
        mk, plain = bk.bdpt_megakernel_pixels, bk.bdpt_megakernel_pixels_plain
    n = mk.launches
    got = mk(*a, **kw)
    want = plain(*a, **kw)
    torch.cuda.synchronize()
    assert mk.launches - n == launches
    assert _frac_close(got, want) >= 0.999
    assert _counters(got) == _counters(want) and _counters(got)[0] > 0


PT_MODE_CASES = ["depth 1", "depth 80", "spp_loop 1", "injected", "ranges"]


@pytest.mark.parametrize("case", BRUTE_CASES + PT_MODE_CASES)
def test_brute_pt_schedule_matches_plain(case, monkeypatch):
    """The brute-force PT kernel on its persistent grid, its lanes running a
    flat bounce loop: rays mode at depth 10 on the brute-force edge cases,
    with inactive lanes 0 and each live lane's radiance to the bit that of
    the same lanes launched alone, packed; pixels mode at depth 1 (cornell)
    and 80 (the mixed scene), with spp_loop 1 (a stratum a lane), over 4
    stratum ranges (4 launches, a budget of one stratum each), and rays
    mode with injected uniforms.  Radiance on >= 99.9% of lanes, all five
    counters exact."""
    key = rng.prng_key(17)
    if case in BRUTE_CASES or case == "injected":
        scene = presets.cornell_box(device="cuda")
        o, d, ids = _cornell_lanes(case, 32, "bpt_pt_blocks")
        kw = {}
        if case == "injected":
            kw["uniforms"] = torch.from_numpy(np.random.default_rng(33).uniform(
                size=(10 * NU, ids.numel())).astype(np.float32)).cuda()
        a = (scene, o, d, ids, key, 10)
        mk, plain = pk.pt_megakernel, pk.pt_megakernel_plain
    else:
        scene = _scene("mixed" if case == "depth 80" else "cornell")
        W, S = 16, 2
        cc = camera_constants(dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                                                  samples_per_pixel=S * S),
                              torch.float32, "cuda")
        pix = torch.arange(W * W, dtype=torch.int32, device="cuda")
        sx = sy = torch.zeros(W * W, device="cuda")
        kw = dict(spp_loop=S * S, sqrt_spp=S)
        if case == "spp_loop 1":  # each stratum a lane, its absolute sample id
            st = torch.arange(S * S, dtype=torch.int32, device="cuda").repeat_interleave(W * W)
            pix = pix.repeat(S * S)
            sx, sy = (st % S).float(), (st // S).float()
            ids = pix * (S * S) + st
            kw = dict(spp_loop=1, sqrt_spp=S)
        else:
            ids = pix.clone()
        ids[3::7] = -1
        a = (scene, (pix % W).float(), (pix // W).float(), sx, sy, ids, pk.camera_table(cc), key,
             {"depth 1": 1, "depth 80": 80}.get(case, 10))
        mk, plain = pk.pt_megakernel_pixels, pk.pt_megakernel_pixels_plain
        if case == "ranges":
            monkeypatch.setattr(pk, "STRATA_BYTES", 12 * W * W)
    n = mk.launches
    got = mk(*a, **kw)
    want = plain(*a, **kw)
    torch.cuda.synchronize()
    assert mk.launches == n + (4 if case == "ranges" else 1)
    assert _frac_close(got, want) >= 0.999
    assert _walk_counters(got) == _walk_counters(want)
    live = ids >= 0
    if int(live.sum()) > 100:
        assert _walk_counters(got)[0] > 0
    if case in BRUTE_CASES:
        packed = mk(scene, Vec3(*(x[live] for x in o)), Vec3(*(x[live] for x in d)), ids[live],
                    key, 10)
        assert all(float(c[~live].abs().sum()) == 0.0 for c in got[:3])
        assert all(torch.equal(c[live], pc) for c, pc in zip(got[:3], packed[:3]))
        assert _walk_counters(packed) == _walk_counters(got)


@pytest.mark.parametrize("nk, B, first", [(16, (1 << 18) + 5, True), (3, 37, False),
                                         (1, 1, True)])
def test_strata_sum_matches_plain_bitwise(nk, B, first):
    """The in-order sum of a launch's per-sample radiance: bit for bit its
    plain version's adds, from zeros or onto given totals; one launch; a
    raise for rows it does not take."""
    g = np.random.default_rng(B)
    rows = torch.from_numpy(g.normal(size=(3, nk, B)).astype(np.float32)).cuda()
    start = torch.from_numpy(g.normal(size=(3, B)).astype(np.float32)).cuda()
    n = pk.strata_sum.launches
    got = pk.strata_sum(rows, start.clone(), first)
    want = pk.strata_sum_plain(rows, start.clone(), first)
    torch.cuda.synchronize()
    assert pk.strata_sum.launches == n + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError):  # the kernel takes float32 rows only
        pk.strata_sum(rows.double(), start.clone(), first)


ANY_CASES = ["B=1", "B=31", "B=37", "all dead", "one live lane", "all live"]


@pytest.mark.parametrize("case", ANY_CASES)
def test_any_bvh_refill_matches_plain_bitwise(case):
    """Every answer and all four counters on the 964-triangle scene, the
    plain walk's: B = 1, 31, 37; 65,536 dead lanes; one live lane among
    1,048,576 dead ones; every lane of 65,536 live.  A dead lane misses."""
    scene = big_scene(builder, device="cuda")
    B = {"one live lane": 1 << 20, "all dead": 65536, "all live": 65536}.get(
        case, int(case[2:]) if case.startswith("B=") else 0)
    g = np.random.default_rng(41)
    live_at = int(g.integers(0, B))
    o, d, _ = _big_lanes(B, 41)
    tmax = torch.from_numpy(g.uniform(0.1, 6.0, B).astype(np.float32)).cuda()
    if case == "all dead":
        tmax[:] = 0.0
    elif case == "one live lane":
        keep = tmax[live_at].clone()
        tmax[:] = -1.0
        tmax[live_at] = keep
    elif case != "all live":
        tmax[2::5] = 0.0
    live = tmax > 0
    got = pw.any_bvh(scene, o, d, tmax)
    if case == "one live lane":  # the plain walk of the live lane alone
        sel = torch.tensor([live_at], device="cuda")
        want = pw.any_bvh_plain(scene, Vec3(*(x[sel] for x in o)), Vec3(*(x[sel] for x in d)),
                                tmax[sel])
        assert bool(got[0][live_at]) == bool(want[0][0])
        assert not bool(got[0][~live].any())
    else:
        want = pw.any_bvh_plain(scene, o, d, tmax)
        assert torch.equal(got[0], want[0])
    torch.cuda.synchronize()
    assert got[1].tolist() == want[1].tolist()
    assert not bool(got[0][~live].any())
    if int(live.sum()) > 1000:
        assert bool(got[0].any())


def _textured_wave(big):
    """The textured-light scene of tests/test_torch_textured_wave.py on the
    card and 8,192 rays from its camera point."""
    from bpt_tpu_torch.scene import textures

    scene = textured_wave_scene(builder, textures, big, True, device="cuda")
    B = 8192
    g = np.random.default_rng(9 + int(big))
    o = torch.tensor([0.0, 2.0, 6.0], device="cuda").expand(B, 3)
    tgt = torch.from_numpy(np.c_[g.uniform(-3, 3, B), g.uniform(0, 7, B),
                                 np.zeros(B)].astype(np.float32)).cuda()
    return (scene, Vec3(*o.unbind(1)), Vec3(*(tgt - o).unbind(1)),
            torch.arange(B, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("big", [False, True], ids=["brute", "bvh"])
def test_textured_pt_wave_matches_plain(big):
    """pt_wave's textured mode (closest_tri's hits on the scene without a
    BVH, closest_bvh's on the other, the shade with albedo 1, the texel
    stage) against its plain version: radiance on >= 99.9% of lanes, rays
    and counters exact."""
    scene, o, d, ids = _textured_wave(big)
    n, k = pw.pt_wave_bounce.launches, (pw.closest_bvh if big else ki.closest_tri).launches
    got = pw.pt_wave(scene, o, d, ids, rng.prng_key(3), 4)
    want = pw.pt_wave_plain(scene, o, d, ids, rng.prng_key(3), 4)
    torch.cuda.synchronize()
    assert pw.pt_wave_bounce.launches == n + 4
    assert (pw.closest_bvh if big else ki.closest_tri).launches == k + 4
    assert _frac_close(got, want) >= 0.999
    assert int(got[3]) == int(want[3]) and got[4].tolist() == want[4].tolist()
    assert float(torch.stack(got[:3]).sum()) > 0


@pytest.mark.parametrize("big", [False, True], ids=["brute", "bvh"])
def test_wave_bounce_writes_the_hit_point_of_every_live_hit(big):
    """One shade launch: every lane that hit, those ending on the checker
    light included, leaves its hit point in its origin, as the plain
    version does; a miss keeps its origin."""
    scene, o, d, ids = _textured_wave(big)
    B = ids.shape[0]
    state = torch.zeros((pw.STATE_ROWS, B), device="cuda")
    state[pw.OX:pw.DX + 3] = torch.stack([*o, *d])
    state[pw.THR:pw.THR + 3] = 1.0
    state[pw.ALIVE] = 1.0
    alive = state[pw.ALIVE] > 0.5
    if big:
        t, tri = pw.closest_bvh(scene, o, d, alive)[:2]
    else:
        t, tri = pw.closest_sweep(scene, o, d, alive)[:2]
    kb, kc = pw.pt_wave_bounce(scene, state, ids, rng.prng_key(4), 0, (t, tri))
    pb, pc = pw.pt_wave_bounce_plain(scene, state, ids, rng.prng_key(4), 0, (t, tri))
    hit = tri >= 0
    ended = hit & (kb[pw.ALIVE] < 0.5)
    assert int(ended.sum()) > 100 and kc.tolist() == pc.tolist()
    for k in range(3):
        p = o[k] + torch.where(hit, t, 0.0) * d[k]
        assert torch.equal(kb[pw.OX + k][hit], p[hit])
        assert torch.equal(kb[pw.OX + k][~hit], o[k][~hit])
        assert torch.equal(kb[pw.OX + k], pb[pw.OX + k])



# ------------------------------------------------------------- volumes


def _volume_lanes(big, B, seed):
    """Rays into the smoke cornell box from its camera position, or from
    (0, 2, 6) at the large volume scene's box; one lane in 13 inactive."""
    g = np.random.default_rng(seed)
    if big:
        o = np.tile([[0.0, 2.0, 6.0]], (B, 1))
        d = np.c_[g.uniform(-2, 2, B), g.uniform(0, 3, B), np.zeros(B)] - o
    else:
        o = np.tile([[278.0, 278.0, -800.0]], (B, 1))
        d = g.uniform(50, 500, (B, 3)) - o
    o, d = (torch.from_numpy(x.astype(np.float32)).cuda() for x in (o, d))
    ids = torch.arange(B, dtype=torch.int32, device="cuda")
    ids[5::13] = -1
    return Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), ids


def _volume_scene(big, texture=None):
    from torch_parity import smoke_scene, volume_big_scene

    if big:
        return volume_big_scene(builder, texture=texture, device="cuda")
    return smoke_scene(builder, device="cuda")


def _agree(got, want, atol):
    g, w = torch.stack(got[:3], 1), torch.stack(want[:3], 1)
    ok = ((g - w).abs() <= atol + 1e-4 * w.abs()).all(dim=1)
    return float(ok.double().mean())


@pytest.mark.parametrize("big", [False, True], ids=["brute", "walk"])
@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
@pytest.mark.parametrize("injected", [True, False], ids=["buffer", "rng"])
def test_volume_rays_mode_matches_plain(big, integrator, injected):
    """The volume mode of both megakernels (the _vol kernels) in rays mode
    against the plain versions: >= 99.9% of lanes within rtol 1e-4 / atol
    1e-6 (PT) or 1e-5 (BDPT), every counter exact, one volume launch."""
    scene = _volume_scene(big)
    assert scene.num_volumes and pk.use_walk(scene) == big
    B, depth = (2048, 6) if big else (8192, 8)
    o, d, ids = _volume_lanes(big, B, 17)
    V = scene.num_volumes
    mod, kw = (pk, {}) if integrator == "pt" else (bk, dict(mis=integrator == "bdpt-mis"))
    rows = depth * (NU + V) if integrator == "pt" else bk.n_uniform_slots(depth, V)
    u = (torch.from_numpy(np.random.default_rng(18).uniform(size=(rows, B))
                          .astype(np.float32)).cuda() if injected else None)
    mk = getattr(mod, "pt_megakernel" if integrator == "pt" else "bdpt_megakernel")
    plain = getattr(mod, mk.__name__ + "_plain")
    n = mk.vol_launches
    got = mk(scene, o, d, ids, rng.prng_key(4), depth, uniforms=u, **kw)
    want = plain(scene, o, d, ids, rng.prng_key(4), depth, uniforms=u, **kw)
    torch.cuda.synchronize()
    assert mk.vol_launches == n + 1
    assert _agree(got, want, 1e-6 if integrator == "pt" else 1e-5) >= 0.999
    assert [int(x) for x in got[3:-1]] == [int(x) for x in want[3:-1]]
    assert torch.equal(got[-1], want[-1])
    assert float(torch.stack(got[:3]).sum()) > 0


@pytest.mark.parametrize("big", [False, True], ids=["brute", "walk"])
@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
def test_volume_pixels_mode_matches_plain(big, integrator):
    """The volume mode in pixels mode (raygen, the keys after NU + V or
    NT + V slots a bounce) at 32x32 x 4 spp against the plain versions."""
    scene = _volume_scene(big)
    W, depth = 32, 6
    if big:
        from bpt_tpu_torch.scene.types import CameraConfig

        cfg = CameraConfig(image_width=W, samples_per_pixel=4, vfov=40.0,
                           lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    else:
        cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                                  samples_per_pixel=4)
    cam = pk.camera_table(camera_constants(cfg, torch.float32, "cuda"))
    pix = torch.arange(W * W, dtype=torch.int64, device="cuda")
    i, j = (pix % W).float(), (pix // W).float()
    if integrator == "pt":
        a, kw, mk = (scene, i, j, i * 0, j * 0, pix, cam, rng.prng_key(6), depth), dict(
            spp_loop=4, sqrt_spp=2), pk.pt_megakernel_pixels
    else:
        a, kw, mk = ((scene, i, j, pix, cam, rng.prng_key(6), depth, 2),
                     dict(mis=integrator == "bdpt-mis"), bk.bdpt_megakernel_pixels)
    plain = getattr(pk if integrator == "pt" else bk, mk.__name__ + "_plain")
    got = mk(*a, **kw)
    want = plain(*a, **kw)
    torch.cuda.synchronize()
    assert _agree(got, want, 1e-6 if integrator == "pt" else 1e-5) >= 0.999
    assert [int(x) for x in got[3:-1]] == [int(x) for x in want[3:-1]]
    assert torch.equal(got[-1], want[-1])


@pytest.mark.parametrize("textured", [False, True], ids=["untextured", "textured"])
def test_volume_pt_wave_matches_plain(textured):
    """pt_wave_bounce's volume mode (pt_wave_bounce_vol) on the large
    volume scene, with a checker on the volume's phase function when
    textured (the shade marks volume lanes for the texel stage)."""
    from bpt_tpu_torch.scene.textures import TextureSpec

    tex = TextureSpec.checker(0.35, (0.9, 0.3, 0.2), (0.2, 0.4, 0.9)) if textured else None
    scene = _volume_scene(True, texture=tex)
    o, d, ids = _volume_lanes(True, 4096, 21)
    key = rng.prng_key(8)
    n = pw.pt_wave_bounce.vol_launches
    got = pw.pt_wave(scene, o, d, ids, key, 5)
    want = pw.pt_wave_plain(scene, o, d, ids, key, 5)
    torch.cuda.synchronize()
    assert pw.pt_wave_bounce.vol_launches == n + 5
    assert _agree(got, want, 1e-6) >= 0.999
    assert int(got[3]) == int(want[3]) and torch.equal(got[4], want[4])


def test_volume_free_kernels_unchanged_by_the_volume_tables():
    """A scene without volumes launches the volume-free kernels: no volume
    launch, and the brute PT kernel's output equal to the bit across two
    calls."""
    scene = presets.cornell_box(device="cuda")
    o, d, ids = _volume_lanes(False, 4096, 23)
    n = (pk.pt_megakernel.launches, pk.pt_megakernel.vol_launches)
    a = pk.pt_megakernel(scene, o, d, ids, rng.prng_key(1), 6)
    b = pk.pt_megakernel(scene, o, d, ids, rng.prng_key(1), 6)
    assert (pk.pt_megakernel.launches, pk.pt_megakernel.vol_launches) == (n[0] + 2, n[1])
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


# ------------------------------------------------ float64 on BVH scenes


def _f64_lanes(scene, B, seed, production=False):
    """B rays in the scene's root box at f64 (a few with zero direction
    components and origins on a box plane: the NaN slab terms), per-lane
    tmin (half T_MIN, half in [-1, 1)) and tmax (half inf, half within the
    box's extent), some NaN bounds, tmax 0 and -1, one lane in eight
    inactive; ``production``: (T_MIN, inf) for every lane."""
    g = np.random.default_rng(seed)
    lo, hi = (x.cpu().numpy() for x in (scene.bvh_min[0], scene.bvh_max[0]))
    o = g.uniform(lo, hi, (B, 3))
    d = g.normal(size=(B, 3))
    d[:8, 0] = 0.0
    o[:4, 0] = lo[0]
    tmin = np.where(g.uniform(size=B) < 0.5, 1e-3, g.uniform(-1.0, 1.0, B))
    tmax = np.where(g.uniform(size=B) < 0.5, np.inf, g.uniform(0.0, (hi - lo).max(), B))
    tmin[::89], tmax[::97], tmax[::53], tmax[::61] = np.nan, np.nan, 0.0, -1.0
    if production:
        tmin, tmax = np.full(B, 1e-3), np.full(B, np.inf)
    active = g.uniform(size=B) > 0.125

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return (Vec3(*(T(o[:, k]) for k in range(3))), Vec3(*(T(d[:, k]) for k in range(3))),
            T(tmin), T(tmax), T(active))


def _f64_scene(which):
    if which == "big":
        return big_scene(builder, device="cuda", dtype=torch.float64)
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml

    root = __file__.rsplit("/tests/", 1)[0]
    return load_scene_from_yaml(f"{root}/scenes/coffee/coffee_standin.yaml",
                                dtype=torch.float64, device="cuda", verbose=False).scene


def _close64(got, want):
    """t, u, v within 1e-12 relative (inf equal to inf), every other output
    equal."""
    for k, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.float64:
            assert torch.allclose(a, b, rtol=1e-12, atol=1e-12, equal_nan=True), k
        else:
            assert torch.equal(a, b), k


@pytest.mark.parametrize("interval", ["lanes", "production"])
@pytest.mark.parametrize("which, B", [("big", 8192), ("coffee", 4096)])
def test_f64_walk_kernels_match_plain(which, B, interval):
    """closest_bvh and any_bvh in float64 against the plain walk on
    the 964-triangle scene and the coffee stand-in: random rays, per-lane
    intervals with NaN, 0 and negative bounds, inactive lanes; hit, tri
    and the four counters exact, t, u, v within 1e-12."""
    scene = _f64_scene(which)
    o, d, tmin, tmax, active = _f64_lanes(scene, B, 31, interval == "production")
    n, n64 = pw.closest_bvh.launches, pw.closest_bvh.f64_launches
    got = pw.closest_bvh(scene, o, d, active, tmin, tmax)
    want = pw.closest_bvh_plain(scene, o, d, active, tmin, tmax)
    torch.cuda.synchronize()
    assert (pw.closest_bvh.launches - n, pw.closest_bvh.f64_launches - n64) == (1, 1)
    _close64(got[:4], want[:4])
    assert got[4].tolist() == want[4].tolist()
    assert bool((got[1] >= 0).any())
    tm = torch.where(active, tmax, 0.0)
    n64 = pw.any_bvh.f64_launches
    hit, c = pw.any_bvh(scene, o, d, tm, tmin)
    want_hit, want_c = pw.any_bvh_plain(scene, o, d, tm, tmin)
    torch.cuda.synchronize()
    assert pw.any_bvh.f64_launches == n64 + 1
    assert torch.equal(hit, want_hit) and c.tolist() == want_c.tolist()
    assert bool(hit.any()) and not bool(hit[~(tm > 0)].any())


@pytest.mark.parametrize("case", REFILL_CASES)
def test_f64_closest_bvh_refill_matches_plain(case):
    """The float64 grid's edge cases (its own occupancy): B = 1, 31, 37,
    four grids and 5 lanes more, every lane inactive, one live lane in ten
    scattered; answers and counters the plain walk's."""
    from bpt_tpu_torch.ops.kernels import build

    scene = big_scene(builder, device="cuda", dtype=torch.float64)
    grid = build.load_library().bpt_bvh_f64_blocks(0)
    assert 0 < grid <= build.load_library().bpt_wave_blocks()
    B = {"several refills": 4 * grid * 128 + 5, "scattered": 65536,
         "all inactive": 4096}.get(case, int(case[2:]) if case.startswith("B=") else 0)
    o, d, tmin, tmax, active = _f64_lanes(scene, B, 23)
    if case == "scattered":
        active = torch.from_numpy(np.random.default_rng(23).uniform(size=B) < 0.1).cuda()
    elif case == "all inactive":
        active[:] = False
    got = pw.closest_bvh(scene, o, d, active, tmin, tmax)
    want = pw.closest_bvh_plain(scene, o, d, active, tmin, tmax)
    torch.cuda.synchronize()
    _close64(got[:4], want[:4])
    assert got[4].tolist() == want[4].tolist()


@pytest.mark.parametrize("integrator", ["pt", "bdpt-mis"])
def test_render_f64_bvh_scene_on_card_matches_cpu(integrator):
    """A float64 render of the 964-triangle scene on the card: the stratum
    loop over the float64 walk kernels, no plain walk, and the CPU's
    image and rays."""
    from bpt_tpu_torch.ops import soa

    cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=16,
                              samples_per_pixel=4, max_depth=4, integrator=integrator,
                              vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    nc, na = pw.closest_bvh.f64_launches, pw.any_bvh.f64_launches
    walks = soa.bvh_closest.calls + soa.bvh_any.calls
    gpu = render(big_scene(builder, device="cuda", dtype=torch.float64), cfg, seed=3)
    assert pw.closest_bvh.f64_launches > nc
    assert (pw.any_bvh.f64_launches > na) == (integrator != "pt")
    assert soa.bvh_closest.calls + soa.bvh_any.calls == walks
    cpu = render(big_scene(builder, device="cpu", dtype=torch.float64), cfg, seed=3)
    ok = np.isclose(gpu.framebuffer_sum, cpu.framebuffer_sum, rtol=1e-9, atol=1e-9)
    assert ok.all(axis=-1).mean() >= 0.99  # the card's libm may branch a path on an ulp
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= 10
    assert abs(gpu.stats.shadow_rays - cpu.stats.shadow_rays) <= 0.01 * cpu.stats.shadow_rays


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_glass_northstar_on_card(dtype, tmp_path):
    """The glass stand-in at 640x360, 64 spp, depth 80, PT, seed 0 within
    1.5% downsampled RMSE of the reference binary's render: float32 through
    the brute-force megakernel, float64 through the stratum loop over the
    float64 walk kernels (tools/torch_northstar_glass.py; ~1 s and ~20 s
    on an H100)."""
    import importlib.util

    root = __file__.rsplit("/tests/", 1)[0]
    spec = importlib.util.spec_from_file_location("torch_northstar_glass",
                                                  f"{root}/tools/torch_northstar_glass.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--dtype", dtype, "--out-dir", str(tmp_path)]) == 0
