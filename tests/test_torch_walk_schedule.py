"""The persistent megakernels' stratum-range plan, on the CPU.

In pixels mode the walk kernels (``csrc/pt_megakernel.cu``,
``csrc/bdpt_megakernel.cu``) and the brute-force BDPT kernel write each
sample's radiance on its own, stratum by stratum, and the wrapper adds a
range's rows into the pixel totals in stratum order
(``pt_kernel.walk_launches``), over as many launches as
``pt_kernel.stratum_ranges`` plans within ``STRATA_BYTES``.  Checked
here: the plan covers every sample id once, in stratum order, each range
within the budget; the BDPT wrapper's vertex scratch, sized for its
largest launch's grid (``bdpt_kernel.scratch_shape``); and the per-stratum plain outputs added in
the plan's order equal the plain pixels versions, which sum a pixel's
strata in one loop, bit for bit (the float-add sequence of a lane that
sums its strata in order, as the brute-force PT kernel does)."""

import dataclasses

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.models.camera import camera_constants
from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
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
