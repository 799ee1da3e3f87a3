"""The refilling wave kernel's slab test (csrc/wave_walk.cuh) on the CPU:
the slab test without NaN checks, and the per-ray decision to take it, in a
float32 torch emulation of its arithmetic in the kernel's order, against
``slab_axis``'s on adversarial rays (origins on box planes, |1/d| up to
3e38, boxes far from the origin): the same entry and exit to the bit
wherever the decision takes it.  And ``bounds_ok``, the per-scene half of
that decision.  The kernel itself is held against ``ops.soa.bvh_closest``
on the card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

from bpt_tpu_torch.ops.intersect import T_MIN
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from torch_parity import big_scene

INF = torch.tensor(float("inf"))


def _slab_axis(lo_b, hi_b, o, inv):
    """bvh_walk.cuh::slab_axis: a NaN term leaves the axis unconstrained."""
    t0, t1 = (lo_b - o) * inv, (hi_b - o) * inv
    nan = t0.isnan() | t1.isnan()
    return (torch.where(nan, -INF, torch.fmin(t0, t1)),
            torch.where(nan, INF, torch.fmax(t0, t1)))


def _slab_finite(lo_b, hi_b, o, inv):
    """wave_walk.cuh::slab_finite: fminf / fmaxf of the same two products."""
    t0, t1 = (lo_b - o) * inv, (hi_b - o) * inv
    return torch.fmin(t0, t1), torch.fmax(t0, t1), t0.isnan() | t1.isnan()


def _fast(org, inv):
    """WaveWalk::start's decision, once a ray: origin and 1/d finite."""
    return torch.isfinite(org).all(dim=-1) & torch.isfinite(inv).all(dim=-1)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _entry_exit(slab, lo, hi, o, inv, t_best):
    """bvh_walk's box test: fmaxf / fminf over the axes, T_MIN and t_best."""
    los, his = zip(*(slab(lo[:, a], hi[:, a], o[:, a], inv[:, a])[:2] for a in range(3)))
    enter = torch.fmax(torch.fmax(los[0], los[1]), torch.fmax(los[2], torch.tensor(T_MIN)))
    return enter, torch.fmin(torch.fmin(his[0], his[1]), torch.fmin(his[2], t_best))


@pytest.mark.parametrize("seed", [3, 4])
def test_finite_slab_equals_slab_axis_on_adversarial_rays(seed):
    g = np.random.default_rng(seed)
    n = 4096
    scale = 10.0 ** g.integers(-3, 39, (n, 1))  # boxes up to 1e38 from the origin
    lo = np.clip(g.uniform(-1.0, 1.0, (n, 3)) * scale, -3.4e38, 3.4e38)
    hi = np.clip(lo + np.abs(g.normal(size=(n, 3))) * 10.0 ** g.integers(-6, 38, (n, 1)),
                 -3.4e38, 3.4e38)
    lo, hi = (torch.from_numpy(x.astype(np.float32)) for x in (lo, hi))
    o = torch.from_numpy((g.normal(size=(n, 3)) * 10.0 ** g.integers(-3, 38, (n, 1)))
                         .astype(np.float32))
    # half the origins on one of the box's planes
    rows, axis = torch.arange(n // 2), torch.from_numpy(g.integers(0, 3, n // 2))
    side = torch.from_numpy(g.uniform(size=n // 2) < 0.5)
    o[rows, axis] = torch.where(side, lo[rows, axis], hi[rows, axis])
    # |1/d| up to 3e38 (d down to 1/3e38, a denormal), zeros and infinities
    d = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    tiny = torch.from_numpy(g.uniform(size=(n, 3)) < 0.2)
    d = torch.where(tiny, torch.sign(d) / torch.from_numpy(
        g.uniform(1e30, 3e38, (n, 3)).astype(np.float32)), d)
    d[::17, 1] = 0.0
    d[::29, 2] = -0.0
    o[::31, 0] = float("inf")
    o[::37, 2] = float("nan")
    inv = 1.0 / d
    assert float(inv.abs()[torch.isfinite(inv)].max()) >= 1e38
    fast = _fast(o, inv)
    assert 0.5 * n <= int(fast.sum()) < n
    assert not bool(fast[::17].any() | fast[::29].any() | fast[::31].any() | fast[::37].any())
    for a in range(3):
        want = _slab_axis(lo[:, a], hi[:, a], o[:, a], inv[:, a])
        got_lo, got_hi, nan = _slab_finite(lo[:, a], hi[:, a], o[:, a], inv[:, a])
        assert not bool(nan[fast].any())
        assert torch.equal(_bits(got_lo[fast]), _bits(want[0][fast]))
        assert torch.equal(_bits(got_hi[fast]), _bits(want[1][fast]))
    t_best = torch.from_numpy(g.uniform(0, 1e3, n).astype(np.float32))
    t_best[::3] = float("inf")
    want = _entry_exit(_slab_axis, lo, hi, o, inv, t_best)
    got = _entry_exit(_slab_finite, lo, hi, o, inv, t_best)
    for x, y in zip(got, want):
        assert torch.equal(_bits(x[fast]), _bits(y[fast]))
    # the slow rays do need the checks: some of their terms are NaN
    assert bool(_slab_finite(lo[:, 1], hi[:, 1], o[:, 1], inv[:, 1])[2][::17].any())


def test_bounds_ok_reads_the_node_bounds():
    """closest_bvh takes the finite-ray slab only in a scene whose node
    bounds hold no NaN (a NaN vertex would put one there)."""
    import dataclasses

    scene = big_scene(tbuilder, device="cpu")
    assert tw.bounds_ok(scene) is True
    lo = scene.bvh_min.clone()
    lo[5, 2] = float("nan")
    assert tw.bounds_ok(dataclasses.replace(scene, bvh_min=lo)) is False
    hi = scene.bvh_max.clone()
    hi[0, 0] = float("inf")  # an infinite bound leaves no NaN term
    assert tw.bounds_ok(dataclasses.replace(scene, bvh_max=hi)) is True
