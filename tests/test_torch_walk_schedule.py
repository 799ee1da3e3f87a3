"""The persistent megakernels' launch plans and stratum-range sums, on the
CPU.

In pixels mode the walk kernels (``csrc/pt_megakernel.cu``,
``csrc/bdpt_megakernel.cu``) and both brute-force kernels write each
sample's radiance on its own, stratum by stratum, and the wrapper adds a
range's rows into the pixel totals in stratum order
(``pt_kernel.walk_launches``), over as many launches as
``pt_kernel.stratum_ranges`` plans within ``STRATA_BYTES``.  Checked
here: the plan covers every sample id once, in stratum order, each range
within the budget; the BDPT wrapper's vertex scratch, sized for its
largest launch's grid (``bdpt_kernel.scratch_shape``); the brute-force PT
wrapper's launches (work split and persistent grid from the occupancy
query, read through a stand-in for the CUDA library) and its raise when
that query fails; the brute-force hit wrappers' launches (``closest_tri``
/ ``any_tri``: the persistent grid from ``bpt_tri_blocks``, a zeroed work
counter for each launch, no launch over no lane, a raise when the query
fails) and their triangle table, packed once a scene; the in-order sum (``pt_kernel.strata_sum``); and the
per-stratum plain outputs added in the plan's order equal the plain
pixels versions, which sum a pixel's strata in one loop, bit for bit
(the float-add sequence of a lane that sums its strata in order)."""

import contextlib
import ctypes
import dataclasses
import gc
import types

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
from bpt_tpu_torch.ops.kernels import intersect as ki
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.scene import builder, presets
from torch_parity import big_scene


@pytest.mark.parametrize("B, spp, budget", [
    (1 << 18, 1024, None),       # the north star's chunk: 13 ranges of <= 85 strata
    (1000, 7, 12 * 1000 * 3),    # a ragged last range: [0, 3), [3, 6), [6, 7)
    (1, 16, None),               # one lane: one range
    (37, 9, 12 * 37),            # one stratum a range
    (37, 1, 1),                  # one stratum over the budget still runs
])
def test_stratum_ranges_cover_every_sample_in_order(B, spp, budget):
    ranges = pk.stratum_ranges(B, spp, budget)
    budget = pk.STRATA_BYTES if budget is None else budget
    assert ranges[0][0] == 0 and ranges[-1][1] == spp
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k1 > k0 for k0, k1 in ranges)
    if 12 * B <= budget:
        assert all(12 * B * (k1 - k0) <= budget for k0, k1 in ranges)
        assert all(12 * B * (k1 - k0 + 1) > budget for k0, k1 in ranges[:-1])
    else:
        assert all(k1 - k0 == 1 for k0, k1 in ranges)
    if B * spp <= 1 << 16:
        # the launches' work items lane * nk + (k - k0), as the kernels
        # number them: the sample ids pix * spp + k, each once, and a
        # lane's strata in ascending order
        seen = []
        for k0, k1 in ranges:
            nk = k1 - k0
            item = np.arange(B * nk)
            lane, k = item // nk, k0 + item % nk
            seen.append(lane * spp + k)
        ids = np.concatenate(seen)
        assert np.array_equal(np.sort(ids), np.arange(B * spp))
        per_lane = ids.reshape(-1)[np.argsort(ids // spp, kind="stable")] % spp
        assert np.array_equal(per_lane.reshape(B, spp), np.tile(np.arange(spp), (B, 1)))


@pytest.mark.parametrize("B, spp, blocks, depth, mis, budget", [
    (1 << 18, 16, 660, 10, True, None),     # cornell bdpt-mis 512^2 x 16 spp: one launch
    (1 << 18, 16, 660, 10, False, None),    # cornell bdpt
    (4_194_304, 1, 660, 10, False, None),   # the cornell defocus BDPT wave, rays mode
    (4096, 4, 660, 80, True, None),         # the mixed 64^2 x 4 spp case at depth 80
    (37, 1, 660, 10, True, None),           # under one block of the grid
    (1, 16, 660, 1, False, None),           # one lane, depth 1
    (1000, 7, 400, 10, True, 12 * 1000 * 3),  # ranges [0, 3), [3, 6), [6, 7)
    (0, 1, 660, 10, False, None),           # no lane: one launch of one block
])
def test_bdpt_launch_plan(B, spp, blocks, depth, mis, budget, monkeypatch):
    """Both modes' launches, one a stratum range in order, each on the
    resident blocks or as few as its samples fill (``walk_grid``, as the
    wrapper calls it): the vertex scratch [threads, 2, depth * stride] is
    sized for the largest of them."""
    if budget is not None:
        monkeypatch.setattr(pk, "STRATA_BYTES", budget)
    grids = [pk.walk_grid(lambda: blocks, B * (k1 - k0)) for k0, k1 in pk.stratum_ranges(B, spp)]
    assert all(g == max(1, min(blocks, -(-B * (k1 - k0) // pk.WALK_BLOCK)))
               for g, (k0, k1) in zip(grids, pk.stratum_ranges(B, spp)))
    shape = bk.scratch_shape(B, spp, lambda: blocks, depth, mis)
    threads = max(grids) * pk.WALK_BLOCK
    stride = bk.VTX_STRIDE_MIS if mis else bk.VTX_STRIDE
    assert shape == (threads, 2, depth * stride)
    assert bk.walk_scratch_bytes(threads, depth, mis) == 4 * shape[0] * shape[1] * shape[2]
    if (B, spp) == (1 << 18, 16):  # the cornell main path on an H100: 84,480 threads
        assert grids == [660] and threads == 84_480
        assert bk.walk_scratch_bytes(threads, depth, mis) == (114_892_800 if mis else 94_617_600)


def test_launch_plan_raises_when_the_occupancy_query_fails():
    with pytest.raises(RuntimeError, match="occupancy"):
        bk.scratch_shape(64, 1, lambda: -2, 10, False)


class _FakeLibrary:
    """Stands in for the CUDA library: its occupancy queries return
    ``blocks``, and each ``bpt_pt_megakernel`` call is recorded and
    reports a launch."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.calls = []

    def bpt_pt_blocks(self, walk, vols):
        assert (walk, vols) == (0, 0)  # the cornell box: brute mode, no volumes
        return self.blocks

    def bpt_pt_megakernel(self, *args):
        self.calls.append(args)
        return 0


# bpt_pt_megakernel's arguments: pixels, B, T, L, depth, spp_loop,
# sqrt_spp, N, k0, nk, grid, ...
_PIXELS, _B, _SPP_LOOP, _N, _K0, _NK, _GRID = 0, 1, 5, 7, 8, 9, 10


def _fake_launch(monkeypatch, blocks, mode, B, spp=16):
    """The brute-force PT wrapper's ``bpt_pt_megakernel`` calls for one
    call over B lanes of the cornell box (mode: rays, pixels with spp
    strata in the kernel, or spp_loop 1), and the launches it counted."""
    from bpt_tpu_torch.models.pt import NU
    from bpt_tpu_torch.ops.kernels import build

    lib = _FakeLibrary(blocks)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    scene = presets.cornell_box(device="cpu")
    ids = torch.arange(B, dtype=torch.int32)
    x = torch.zeros(B)
    key = rng.prng_key(3)
    n = pk.pt_megakernel.launches
    if mode == "rays":
        pk._launch(pk.pt_megakernel, scene, [x] * 6, ids, rng.subkeys(key, NU), 10,
                   pixels=False)
    else:
        S = round(spp ** 0.5)
        cam = pk.camera_table(camera_constants(dataclasses.replace(
            presets.cornell_box_camera(), image_width=8, samples_per_pixel=spp),
            torch.float32, "cpu"))
        pk._launch(pk.pt_megakernel, scene, [x] * 4, ids, rng.subkeys_with_raygen(key, NU), 10,
                   pixels=True, cam=cam, spp_loop=spp if mode == "pixels" else 1,
                   sqrt_spp=S)
    return lib.calls, pk.pt_megakernel.launches - n


@pytest.mark.parametrize("mode, B, blocks, budget, launches", [
    # the cornell main path's chunk: one range of 16 strata, 4,194,304 samples
    ("pixels", 1 << 18, 660, None, [(0, 16, 660)]),
    ("pixels", 37, 660, None, [(0, 16, 5)]),          # 592 samples: 5 blocks
    ("pixels", 1000, 4, None, [(0, 16, 4)]),          # more samples than the grid holds
    # ranges of 5 strata: [0, 5), [5, 10), [10, 15), [15, 16)
    ("pixels", 1000, 660, 12 * 1000 * 5, [(0, 5, 40), (5, 5, 40), (10, 5, 40), (15, 1, 8)]),
    ("spp_loop 1", 4096, 660, None, [(0, 1, 32)]),    # a stratum a lane
    ("rays", 4_194_304, 660, None, [(0, 1, 660)]),    # the cornell defocus PT wave
    ("rays", 1, 660, None, [(0, 1, 1)]),
    ("rays", 0, 660, None, [(0, 1, 1)]),              # no lane: the library launches nothing
])
def test_brute_pt_launch_plan(mode, B, blocks, budget, launches, monkeypatch):
    """A sample a work item: one launch a stratum range of
    ``stratum_ranges`` (one in rays mode and with spp_loop 1), each on the
    blocks the card holds at once or as few as its samples fill
    (``walk_grid``), with a 64-bit work counter."""
    if budget is not None:
        monkeypatch.setattr(pk, "STRATA_BYTES", budget)
    calls, launched = _fake_launch(monkeypatch, blocks, mode, B)
    assert launched == len(calls) == len(launches)
    assert [(a[_K0], a[_NK], a[_GRID]) for a in calls] == launches
    assert all(a[_B] == B and a[_N] == 0 and a[_PIXELS] == int(mode != "rays") for a in calls)
    assert all(a[_SPP_LOOP] == (16 if mode == "pixels" else 1) for a in calls)


@pytest.mark.parametrize("mode", ["pixels", "rays"])
def test_brute_pt_launch_raises_when_the_occupancy_query_fails(mode, monkeypatch):
    with pytest.raises(RuntimeError, match="occupancy"):
        _fake_launch(monkeypatch, -2, mode, 64)


class _FakeTriLibrary:
    """Stands in for the CUDA library's brute-force hit entries: the
    occupancy query returns ``blocks``; each launch is recorded with what
    its work counter held, which it then moves past B, as the kernel's
    warps do, and reports a launch."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.queries, self.calls = [], []

    def bpt_tri_blocks(self, f64, any_hit):
        self.queries.append((f64, any_hit))
        return self.blocks

    def _launch(self, args):
        f64, B, T, grid, table = args[:5]
        counter = ctypes.c_int64.from_address(args[-2])
        self.calls.append(dict(f64=f64, B=B, T=T, grid=grid, table=table,
                               counter=counter.value))
        counter.value = B + 4096
        return 0

    def bpt_closest_tri(self, *args):
        return self._launch(args)

    def bpt_any_tri(self, *args):
        return self._launch(args)


def _fake_tri_launch(monkeypatch, lib, which, B, dtype=torch.float32, scene=None):
    """``intersect._launch`` of ``which`` over B cornell lanes through the
    stand-in ``lib``: (the outputs, launches counted)."""
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    scene = presets.cornell_box(device="cpu", dtype=dtype) if scene is None else scene
    x = torch.zeros(B, dtype=dtype)
    wrapper = getattr(ki, which)
    n = wrapper.launches
    outs = ki._launch(which, scene, Vec3(x, x, x), Vec3(x, x, x), x, x)
    return outs, wrapper.launches - n


@pytest.mark.parametrize("which, dtype, B, blocks, grid", [
    ("any_tri", torch.float32, 4096, 2112, 32),         # as many blocks as the lanes fill
    ("any_tri", torch.float64, 129, 1188, 2),
    ("closest_tri", torch.float32, 1, 2112, 1),
    ("closest_tri", torch.float32, 300_000, 2112, 2112),  # the resident blocks
    ("closest_tri", torch.float64, 1000, 4, 4),
])
def test_tri_launch_plan(which, dtype, B, blocks, grid, monkeypatch):
    """One launch a call, on the blocks the card holds at once
    (``bpt_tri_blocks`` of the kernel's instantiation) or as few as the
    lanes fill, 128 lanes a block; the scene's packed table; a zeroed
    64-bit work counter."""
    lib = _FakeTriLibrary(blocks)
    outs, launched = _fake_tri_launch(monkeypatch, lib, which, B, dtype)
    f64, any_hit = int(dtype == torch.float64), int(which == "any_tri")
    assert launched == 1 and lib.queries == [(f64, any_hit)]
    assert lib.calls == [dict(f64=f64, B=B, T=presets.cornell_box(device="cpu").num_tris,
                              grid=grid, table=lib.calls[0]["table"], counter=0)]
    want = [torch.bool] if any_hit else [dtype, torch.int32, dtype, dtype]
    assert [o.dtype for o in outs] == want and all(o.shape == (B,) for o in outs)


def test_tri_launches_get_a_zeroed_work_counter_each(monkeypatch):
    """Each launch takes a counter of its own, zeroed, though the one
    before left its counter past B; every launch reads the scene's one
    packed table."""
    lib = _FakeTriLibrary(2112)
    scene = presets.cornell_box(device="cpu")
    for which in ("any_tri", "closest_tri", "any_tri", "closest_tri"):
        _fake_tri_launch(monkeypatch, lib, which, 256, scene=scene)
    assert [c["counter"] for c in lib.calls] == [0, 0, 0, 0]
    assert {c["table"] for c in lib.calls} == {ki.tri_table(scene).data_ptr()}


@pytest.mark.parametrize("which", ["closest_tri", "any_tri"])
def test_tri_launch_over_no_lane_launches_nothing(which, monkeypatch):
    lib = _FakeTriLibrary(2112)
    outs, launched = _fake_tri_launch(monkeypatch, lib, which, 0)
    assert launched == 0 and lib.calls == [] and lib.queries == []
    assert all(o.shape == (0,) for o in outs)


@pytest.mark.parametrize("which", ["closest_tri", "any_tri"])
def test_tri_launch_raises_when_the_occupancy_query_fails(which, monkeypatch):
    lib = _FakeTriLibrary(-2)
    n = getattr(ki, which).launches
    with pytest.raises(RuntimeError, match="occupancy"):
        _fake_tri_launch(monkeypatch, lib, which, 64)
    assert lib.calls == [] and getattr(ki, which).launches == n


def test_tri_launch_refuses_a_scene_over_the_staged_table(monkeypatch):
    """The kernels stage a whole table of at most 256 triangles; a larger
    scene has a BVH and takes the BVH kernels."""
    lib = _FakeTriLibrary(2112)
    with pytest.raises(ValueError, match="256"):
        _fake_tri_launch(monkeypatch, lib, "closest_tri", 64,
                         scene=big_scene(builder, device="cpu"))
    assert lib.calls == []


def test_tri_table_is_packed_once_a_scene():
    """The brute-force hit kernels' (v0, e1, e2) table is packed at a
    scene's first hit call, reused by every later one, and dropped with
    the scene."""
    scene = presets.cornell_box(device="cpu", dtype=torch.float64)
    table = ki.tri_table(scene)
    assert ki.tri_table(scene) is table
    assert table.shape == (scene.num_tris, 9) and table.dtype == torch.float64
    assert torch.equal(table, torch.cat([scene.v0, scene.e1, scene.e2], dim=1))
    key = id(scene)
    del scene
    gc.collect()
    assert key not in ki.tri_table.cache


@pytest.mark.parametrize("nk, first", [(1, True), (16, True), (5, False)])
def test_strata_sum_adds_in_stratum_order(nk, first):
    """``strata_sum`` on the CPU (its plain version): the rows added into the
    totals one stratum after another, from zeros on a call's first range,
    bit for bit the sequence of single adds."""
    g = np.random.default_rng(nk)
    rows = torch.from_numpy(g.normal(size=(3, nk, 37)).astype(np.float32))
    start = torch.from_numpy(g.normal(size=(3, 37)).astype(np.float32))
    want = torch.zeros(3, 37) if first else start.clone()
    for k in range(nk):
        want = want + rows[:, k]
    n = pk.strata_sum_plain.calls
    got = pk.strata_sum(rows, start.clone(), first)
    assert torch.equal(got, want)
    assert pk.strata_sum_plain.calls == n + 1


def _setup(which, W=4, S=2):
    if which == "cornell":
        scene = presets.cornell_box(device="cpu")
        cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                                  samples_per_pixel=S * S)
    else:
        scene = big_scene(builder, device="cpu")
        cfg = dataclasses.replace(presets.cornell_box_camera(), image_width=W,
                                  samples_per_pixel=S * S, vfov=40.0,
                                  lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    cam = pk.camera_table(camera_constants(cfg, torch.float32, "cpu"))
    pix = torch.arange(W * W)
    pix = torch.where(pix % 5 == 3, -1, pix)  # inactive lanes between live ones
    pixc = pix.clamp_min(0)
    return scene, (pixc % W).float(), (pixc // W).float(), pix, cam


@pytest.mark.parametrize("which", ["cornell", "big"])
@pytest.mark.parametrize("integrator", ["pt", "bdpt", "bdpt-mis"])
def test_strata_in_plan_order_equal_plain_pixels(which, integrator, monkeypatch):
    """A budget of three strata a launch over 4 strata: ranges [0, 3) and
    [3, 4).  Each range's rows are the plain version's per-stratum
    radiance; walk_launches adds them as the kernel wrappers do."""
    scene, i, j, pix, cam = _setup(which)
    S, depth, key = 2, 3, rng.prng_key(5)
    mis = integrator == "bdpt-mis"
    B, spp = pix.shape[0], S * S
    live = pix >= 0
    monkeypatch.setattr(pk, "STRATA_BYTES", 12 * B * 3)
    assert pk.stratum_ranges(B, spp) == [(0, 3), (3, 4)]

    def stratum(k):
        """[3, B] plain radiance of stratum k, zero on the inactive lanes."""
        if integrator == "pt":
            rid = torch.where(live, pix * spp + k, -1)
            kf = torch.full_like(i, float(k % S)), torch.full_like(i, float(k // S))
            return torch.stack(pk.pt_megakernel_pixels_plain(
                scene, i, j, *kf, rid, cam, key, depth)[:3])
        rad = bk.stratum_plain(scene, i, j, pix, cam, key, depth, S, k, mis=mis)[0]
        out = torch.zeros((B, 3))
        out[live] = rad
        return out.T

    def launch(k0, nk, out):
        for kk in range(nk):
            out[:, kk] = stratum(k0 + kk)

    tot = pk.walk_launches(B, True, spp, launch, torch.device("cpu"))
    if integrator == "pt":
        want = pk.pt_megakernel_pixels_plain(scene, i, j, i * 0, j * 0, pix, cam, key, depth,
                                             spp_loop=spp, sqrt_spp=S)
    else:
        want = bk.bdpt_megakernel_pixels_plain(scene, i, j, pix, cam, key, depth, S, mis=mis)
    assert float(torch.stack(want[:3]).abs().sum()) > 0
    assert torch.equal(tot, torch.stack(want[:3]))
