"""The volume kernels' free-flight override (csrc/volume.cuh) against its
plain version, ops/soa.py::volume_interaction, through float32 mirrors,
on the CPU without JAX.

- vol_probes, in the tree: both boundary probes from one sweep that keeps
  the VOL_KEEP smallest valid t's.  ``_one_sweep`` / ``_probes_mirror``
  mirror its selection; they must give the floats of two sweeps
  (vol_closest from -inf, then from t1 + 1e-4f) on synthetic t lists,
  on the Möller–Trumbore t's of lines at the boxes' corners, edges, faces
  and planes, and on the lanes of plain cornell_smoke renders.
- E1, the box cull that tools/volume_variants.py keeps as a candidate
  copy (measured slower and left out of the tree): its packing runs here
  from the tool's source text against this tree's pt_kernel, and
  ``_box_span`` mirrors its CUDA test operation for operation.  The cull
  rests on one claim, held directly: on every lane it may skip, every t
  that Möller–Trumbore accepts lies in the slab interval of the box
  widened by that lane's pad.  Then it never skips a volume that the
  plain version takes (t1, t2 finite and max(t1, T_MIN) < min(t2,
  t_hit)), which is held too.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import sys

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops import soa
from bpt_tpu_torch.ops.kernels import pt_kernel as pk
from bpt_tpu_torch.scene.builder import MaterialSpec as MS, SceneBuilder
from bpt_tpu_torch.scene.loader import load_scene_from_yaml

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import volume_variants as vv  # noqa: E402

torch.set_num_threads(1)

T_MIN = 1e-3


@functools.cache
def _e1():
    """The E1 copy's constants and packing (``pack_vol_boxes``), from
    tools/volume_variants.py's source text, over this tree's pt_kernel."""
    ns = dict(vars(pk), math=math)
    exec(vv.E1_CONSTS_PY, ns)
    exec(vv.E1_PACK_PY, ns)
    return ns


def _boxes(scene):
    """E1's packed rows [MAX_VOLS, VOLB_STRIDE] (float32)."""
    return _e1()["pack_vol_boxes"](scene).reshape(pk.MAX_VOLS, _e1()["VOLB_STRIDE"])


def _box_span(scene, v, o, d):
    """E1's ``vol_box_open`` before it meets (T_MIN, t_hit), in float32,
    operation for operation: (enter [B], exit [B], swept [B] bool), the
    slab interval of each line o + t d over volume v's box widened by its
    pad, and whether the lane is swept whatever that interval (it grazes
    a boundary plane).  A NaN slab term leaves its axis unconstrained."""
    b = _boxes(scene)[v]
    f32 = torch.float32
    dx, dy, dz = (x.to(f32) for x in d)
    d_len = torch.sqrt(dx * dx + dy * dy + dz * dz)
    m = torch.minimum(torch.minimum(torch.abs(dx * b[7] + dy * b[8] + dz * b[9]),
                                    torch.abs(dx * b[10] + dy * b[11] + dz * b[12])),
                      torch.abs(dx * b[13] + dy * b[14] + dz * b[15]))
    cosine = m / d_len - b[6]
    swept = ~(cosine >= _e1()["VOL_C_MIN"])
    cx, cy, cz = (b[a] - x.to(f32) for a, x in enumerate(o))
    g = (torch.abs(cx) + torch.abs(cy) + torch.abs(cz)) + (b[3] + b[4] + b[5])
    pad = _e1()["VOL_PAD_K"] * g / cosine
    enter = exit_ = None
    for a, (ca, da) in enumerate(zip((cx, cy, cz), (dx, dy, dz))):
        ia = 1.0 / da
        w = b[3 + a] + pad
        t0, t1 = (ca - w) * ia, (ca + w) * ia
        nan = torch.isnan(t0) | torch.isnan(t1)
        lo = torch.where(nan, -torch.inf, torch.minimum(t0, t1))
        hi = torch.where(nan, torch.inf, torch.maximum(t0, t1))
        enter = lo if enter is None else torch.maximum(enter, lo)
        exit_ = hi if exit_ is None else torch.minimum(exit_, hi)
    return enter, exit_, swept


def _box_open(scene, v, o, d, t_hit):
    """E1's cull: [B] bool, whether the lane sweeps volume v: it grazes a
    boundary plane, or the segment (T_MIN, t_hit) meets the widened box."""
    enter, exit_, swept = _box_span(scene, v, o, d)
    enter = torch.clamp_min(enter, T_MIN)
    exit_ = torch.minimum(exit_, torch.as_tensor(t_hit, dtype=torch.float32))
    return swept | (exit_ > enter)


def _mt_ts(scene, v, o, d):
    """[n_v, B]: the t of each of volume v's triangles, in the kernel's
    span order, by the kernel's float32 operations; inf where it is not
    accepted or not finite."""
    rows = scene.vol_tri_vol == v
    det, t, u, w = soa._mt_all(scene.vol_v0[rows], scene.vol_e1[rows], scene.vol_e2[rows], o, d)
    ok = soa._mt_valid(det, t, u, w, -torch.inf, torch.inf) & torch.isfinite(t)
    return torch.where(ok, t, torch.inf)


def _probes_mirror(ts):
    """vol_probes over [n, B] t's in sweep order, in float32: (t1, t2),
    the VOL_KEEP smallest kept by the min/max insertion, t2 the first kept
    above t1 + 1e-4f, else the second sweep where a t was dropped."""
    k = [torch.full_like(ts[0], math.inf) for _ in range(pk.VOL_KEEP)]
    dropped = torch.zeros_like(ts[0], dtype=torch.bool)
    for t in ts:
        for i in range(pk.VOL_KEEP):
            k[i], t = torch.minimum(k[i], t), torch.maximum(k[i], t)
        dropped |= t < math.inf
    t1 = k[0]
    lo = t1 + torch.tensor(1e-4, dtype=torch.float32)
    t2 = torch.full_like(t1, math.inf)
    for i in range(pk.VOL_KEEP - 1, 0, -1):
        t2 = torch.where(k[i] > lo, k[i], t2)
    again = torch.where(ts > lo[None], ts, torch.inf).amin(0)
    return t1, torch.where(dropped & ~(t2 < math.inf), again, t2), dropped & ~(t2 < math.inf)


def _sweeps(ts):
    """vol_closest twice over [n, B] t's (strict bounds): (t1, t2)."""
    t1 = ts.amin(0)
    lo = t1 + torch.tensor(1e-4, dtype=torch.float32)
    return t1, torch.where(ts > lo[None], ts, torch.inf).amin(0)


def _smoke():
    return load_scene_from_yaml("scenes/cornell_smoke.yaml", device="cpu", verbose=False)


def _big_volume():
    """chip_smoke.py::big_volume_scene on the CPU: a 964-triangle scene with
    a volume box around a sphere."""
    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, MS.metal((0.8, 0.8, 0.8), 0.05))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), MS.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4), MS.diffuse_light((10, 10, 10)))
    b.add_volume_box((-1.5, 0.01, -1.5), (1.5, 2.5, 1.5), density=0.2, albedo=(0.9, 0.9, 0.9))
    return b.build(device="cpu")


def _rotated():
    """A floor and two boxes turned about y and moved, one of them small
    and far from the origin."""
    b = SceneBuilder()
    b.add_quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), MS.lambertian((0.5, 0.5, 0.5)))
    b.add_volume_box((-1, 0.01, -1), (1, 2, 1.5), 0.3, albedo=(0.2, 0.4, 0.6),
                     rotate_y_degrees=27.0, translate=(0.5, 0.0, -0.25))
    b.add_volume_box((0, 0, 0), (0.02, 0.03, 0.01), 5.0, rotate_y_degrees=-41.0,
                     translate=(1000.0, 3.0, -200.0))
    return b.build(device="cpu")


def _sphere():
    """A floor, a volume box and a volume sphere of 36 boundary triangles
    (many plane orientations: never culled)."""
    b = SceneBuilder()
    b.add_quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), MS.lambertian((0.5, 0.5, 0.5)))
    b.add_volume_box((-3, 0.01, -1), (-1, 2, 1), 0.3)
    b.add_volume_sphere((1.5, 1.0, 0.0), 0.9, 0.5, lat_steps=4, lon_steps=6)
    return b.build(device="cpu")


SCENES = {"cornell_smoke": lambda: _smoke().scene, "big_volume": _big_volume,
          "rotate_y": _rotated}


def _vertices(scene, v):
    """Volume v's boundary vertices v0, v0 + e1, v0 + e2 of the kernels'
    table, in float64 (exact)."""
    vol, _ = pk.pack_vol_tables(scene)
    rows = vol.reshape(pk.MAX_VOL_TRIS, pk.VOL_STRIDE).double()
    r = rows[rows[:, 9] == v]
    v0 = r[:, 0:3]
    return torch.cat([v0, v0 + r[:, 3:6], v0 + r[:, 6:9]])


def _taken(scene, v, o, d, t_hit):
    """Whether the plain override takes volume v on each lane at surface
    t t_hit: both probes finite and max(t1, T_MIN) < min(t2, t_hit)."""
    t1 = soa._vol_closest(scene, v, o, d, -torch.inf, torch.inf)
    t2 = soa._vol_closest(scene, v, o, d, t1 + 1e-4, torch.inf)
    tt1 = torch.clamp_min(t1, T_MIN)
    tt2 = torch.minimum(t2, t_hit)
    return torch.isfinite(t1) & torch.isfinite(t2) & (tt1 < tt2)


def _assert_sound(scene, o, d, t_hit, what):
    """No volume the plain override takes is culled; returns (taken, open)
    lane-volume counts."""
    n_taken = n_open = 0
    for v in range(scene.num_volumes):
        taken = _taken(scene, v, o, d, t_hit)
        open_ = _box_open(scene, v, o, d, t_hit)
        bad = taken & ~open_
        assert not bool(bad.any()), (
            f"{what}: volume {v} culled on {int(bad.sum())} lanes it takes, e.g. o="
            f"{[float(x[bad][0]) for x in o]} d={[float(x[bad][0]) for x in d]}")
        n_taken, n_open = n_taken + int(taken.sum()), n_open + int(open_.sum())
    return n_taken, n_open


# ---------------------------------------- E1 (tools/volume_variants.py)


def _box(scene, v):
    """Volume v's packed row: (centre, half extents, delta, [3, 3] normals)
    in float64."""
    b = _boxes(scene)[v].double()
    return b[0:3], b[3:6], float(b[6]), b[7:16].reshape(3, 3)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_boxes_hold_every_boundary_vertex(name):
    """Each volume's box c +- h holds its boundary vertices exactly and is
    no wider than their bounds' float32 rounding; the rows past the
    volumes are zero."""
    scene = SCENES[name]()
    boxes = _boxes(scene)
    assert boxes.dtype == torch.float32
    for v in range(scene.num_volumes):
        c, h, delta, _ = _box(scene, v)
        pts = _vertices(scene, v).double()
        lo, hi = pts.amin(0), pts.amax(0)
        assert bool((c - h <= lo).all()) and bool((c + h >= hi).all())
        assert bool((h <= torch.maximum(c - lo, hi - c) * (1 + 2.0 ** -22)).all())
        assert 0 < delta < 1e-5
    rest = boxes[scene.num_volumes:]
    assert bool((rest == 0).all())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stored_normals_bound_every_triangle(name):
    """What the pad's rule needs of the normals: for every direction and
    every boundary triangle, s_j |d . n_j| / |d| >= min_k |d . q_k| / |d|
    - delta (q_k the stored normals, s_j the triangle's shape factor),
    in float64 over 20,000 directions, many of them in a triangle's
    plane."""
    scene = SCENES[name]()
    rng = np.random.default_rng(5)
    vol, _ = pk.pack_vol_tables(scene)
    rows = vol.reshape(pk.MAX_VOL_TRIS, pk.VOL_STRIDE).double()
    for v in range(scene.num_volumes):
        _, _, delta, q = _box(scene, v)
        r = rows[rows[:, 9] == v]
        e1, e2 = r[:, 3:6], r[:, 6:9]
        n = torch.linalg.cross(e1, e2)
        s = n.norm(dim=1) / (e1.norm(dim=1) * e2.norm(dim=1))
        d = torch.from_numpy(rng.normal(size=(20000, 3)))
        nu = n / n.norm(dim=1, keepdim=True)
        k = torch.from_numpy(rng.integers(0, len(r), 10000))
        d[:10000] -= (d[:10000] * nu[k]).sum(1, keepdim=True) * nu[k]  # in a plane
        d = d / d.norm(dim=1, keepdim=True)
        lhs = (s[:, None] * (nu @ d.T).abs()).amin(0)
        rhs = (q @ d.T).abs().amin(0) - delta
        assert bool((lhs >= rhs).all())


def test_a_volume_of_many_orientations_is_never_culled():
    """A volume sphere's 36 triangles have more than three plane
    orientations: its delta is inf and every lane sweeps it, also where
    its line misses the sphere's box; the box beside it is culled."""
    scene = _sphere()
    assert int(scene.vol_v0.shape[0]) == 12 + 36
    assert math.isfinite(_box(scene, 0)[2]) and _box(scene, 1)[2] == math.inf
    o = Vec3(torch.tensor([0.0, 0.0]), torch.tensor([50.0, 50.0]), torch.tensor([0.0, 0.0]))
    d = Vec3(torch.tensor([1.0, 0.3]), torch.tensor([0.2, 0.1]), torch.tensor([0.1, 1.0]))
    t_hit = torch.tensor([math.inf, 0.5])
    assert not bool(_box_open(scene, 0, o, d, t_hit).any())
    assert bool(_box_open(scene, 1, o, d, t_hit).all())


@pytest.mark.parametrize("integrator", ["pt", "bdpt"])
def test_override_on_rendered_lanes(integrator, monkeypatch):
    """Every override of a plain cornell_smoke render (32x32, 4 spp, depth
    16): vol_probes' mirror gives the two sweeps' t1 and t2 on every live
    lane; no volume that volume_interaction takes is culled by E1 at the
    t its loop holds there, and E1 leaves far fewer volumes to sweep."""
    smoke = _smoke()
    seen = {"lanes": 0, "taken": 0, "open": 0, "pairs": 0}
    interaction = soa.volume_interaction

    def hooked(scene, o, d, tmin, t_surf, u_rows, active):
        out = interaction(scene, o, d, tmin, t_surf, u_rows, active)
        # volume_interaction's loop, the cull checked at the t it holds
        # for each volume
        d_len = torch.sqrt(d.x * d.x + d.y * d.y + d.z * d.z)
        t_best = t_surf
        for v in range(scene.num_volumes):
            t1 = soa._vol_closest(scene, v, o, d, -torch.inf, torch.inf)
            t2 = soa._vol_closest(scene, v, o, d, t1 + 1e-4, torch.inf)
            tt1 = torch.clamp_min(t1, tmin)
            tt2 = torch.minimum(t2, t_best)
            ok = active & torch.isfinite(t1) & torch.isfinite(t2) & (tt1 < tt2)
            ts = _mt_ts(scene, v, o, d)
            p1, p2, _ = _probes_mirror(ts)
            s1, s2 = _sweeps(ts)
            assert torch.equal(p1[active], s1[active]) and torch.equal(p2[active], s2[active])
            open_ = _box_open(scene, v, o, d, t_best)
            assert not bool((ok & ~open_).any()), f"{integrator}: volume {v} culled"
            seen["taken"] += int(ok.sum())
            seen["open"] += int((open_ & active).sum())
            tt1 = torch.clamp_min(tt1, 0.0)
            hd = scene.vol_neg_inv_density[v] * torch.log(u_rows[v])
            ok = ok & (hd <= (tt2 - tt1) * d_len)
            t_best = torch.where(ok, tt1 + hd / d_len, t_best)
        assert torch.equal(t_best[active], out[1][active])
        seen["lanes"] += int(active.sum())
        seen["pairs"] += int(active.sum()) * scene.num_volumes
        return out

    monkeypatch.setattr(soa, "volume_interaction", hooked)
    cfg = dataclasses.replace(smoke.camera, image_width=32, aspect_ratio=1.0,
                              samples_per_pixel=4, integrator=integrator)
    render(smoke.scene, cfg, seed=0)
    assert seen["lanes"] > 3000 and seen["taken"] > 300
    # the cull leaves fewer than half the (lane, volume) sweeps
    assert seen["open"] < 0.5 * seen["pairs"]


def _lines(kind, scene, rng, n=4096):
    """Lines of one kind against the scene's volumes: (o, d, t_hit)."""
    f32 = np.float32
    pts = [_vertices(scene, v).numpy().astype(np.float64) for v in range(scene.num_volumes)]
    pick = rng.integers(0, scene.num_volumes, n)
    tri = [p.reshape(3, -1, 3) for p in pts]  # v0, v1, v2 of each triangle
    lo = np.stack([pts[v].min(0) for v in pick])
    hi = np.stack([pts[v].max(0) for v in pick])
    span = hi - lo
    far = rng.normal(size=(n, 3))
    far = far / np.linalg.norm(far, axis=1, keepdims=True) * (3 * span.max(1) + 1)[:, None]
    if kind in ("corners", "edges", "faces"):
        k = rng.integers(0, 1 << 30, n)
        tgt = np.empty((n, 3))
        for i, v in enumerate(pick):
            t3 = tri[v][:, k[i] % tri[v].shape[1]]
            if kind == "corners":
                tgt[i] = t3[k[i] % 3]
            elif kind == "edges":
                s = rng.uniform()
                tgt[i] = t3[0] + s * (t3[1 + k[i] % 2] - t3[0])
            else:
                a, b = rng.uniform(size=2)
                if a + b > 1:
                    a, b = 1 - a, 1 - b
                tgt[i] = t3[0] + a * (t3[1] - t3[0]) + b * (t3[2] - t3[0])
        o = (lo + hi) / 2 + far
        d = (tgt - o) * rng.uniform(0.01, 100, (n, 1))
        t_hit = np.full(n, np.inf)
    elif kind == "inside":
        o = lo + rng.uniform(0.02, 0.98, (n, 3)) * span
        d = rng.normal(size=(n, 3)) * rng.uniform(0.01, 1000, (n, 1))
        t_hit = np.where(rng.uniform(size=n) < 0.5, np.inf, rng.exponential(1.0, n))
    elif kind == "plane":
        # origins on a face's plane (the box's side, or half a unit out),
        # direction components zero along that axis and sometimes one more
        boxes = _boxes(scene).double().numpy()
        o = lo + rng.uniform(-0.2, 1.2, (n, 3)) * span
        d = rng.normal(size=(n, 3))
        ax = rng.integers(0, 3, n)
        side = rng.integers(0, 4, n)
        for i, v in enumerate(pick):
            c, h = boxes[v, 0:3], boxes[v, 3:6]
            plane = (c - h, c + h, c - h - 0.5, c + h + 0.5)[side[i]]
            o[i, ax[i]] = plane[ax[i]]
            d[i, ax[i]] = 0.0
            if rng.uniform() < 0.3:
                d[i, (ax[i] + 1) % 3] = 0.0
        t_hit = np.full(n, np.inf)
    elif kind in ("grazing", "near", "grazing_before"):
        # lines at angles of 1e-7 to 1e-2 to a face ("near": 1e-5 to 1e-3,
        # about the cull's threshold, from up to 3,000 box sizes away),
        # through a point of its plane on or beside the face; for
        # "grazing_before" the surface hit lies just before the bare
        # box's entry
        lo_e, hi_e = (-5, -3) if kind == "near" else (-7, -2)
        k = rng.integers(0, 1 << 30, n)
        o, d = np.empty((n, 3)), np.empty((n, 3))
        for i, v in enumerate(pick):
            t3 = tri[v][:, k[i] % tri[v].shape[1]]
            a, b = rng.uniform(-0.1, 1.1, size=2)
            if a + b > 1.2:
                a, b = 1.2 - a, 1.2 - b
            e1, e2 = t3[1] - t3[0], t3[2] - t3[0]
            nrm = np.cross(e1, e2)
            with np.errstate(invalid="ignore"):  # a UV sphere's degenerate pole rows
                nrm /= np.linalg.norm(nrm)
            along = rng.normal(size=3)
            along -= along.dot(nrm) * nrm
            along /= np.linalg.norm(along)
            ang = 10.0 ** rng.uniform(lo_e, hi_e) * rng.choice([-1, 1])
            d[i] = (along * math.cos(ang) + nrm * math.sin(ang)) * 10.0 ** rng.uniform(-2, 3)
            far_k = 10.0 ** rng.uniform(0, 3.5) if kind == "near" else rng.uniform(0.5, 50)
            o[i] = t3[0] + a * e1 + b * e2 - d[i] * far_k * span.max(1)[i] / np.linalg.norm(d[i])
        t_hit = np.full(n, np.inf)
        if kind == "grazing_before":
            o32, d32 = o.astype(f32).astype(np.float64), d.astype(f32).astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                ta, tb = (lo - o32) / d32, (hi - o32) / d32
            enter = np.nanmax(np.minimum(ta, tb), axis=1)
            t_hit = enter - np.abs(enter) * 1e-6 - 1e-9
    else:  # "surface": lines through the box, the surface hit before or behind it
        tgt = lo + rng.uniform(0, 1, (n, 3)) * span
        o = (lo + hi) / 2 + far
        d = tgt - o
        dist = np.linalg.norm(far, axis=1) / np.linalg.norm(d, axis=1)
        t_hit = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.0, 0.9, n) * dist,
                         rng.uniform(1.1, 3.0, n) * dist)
    ov = Vec3(*torch.from_numpy(o.astype(f32)).unbind(1))
    dv = Vec3(*torch.from_numpy(d.astype(f32)).unbind(1))
    return ov, dv, torch.from_numpy(t_hit.astype(f32))


KINDS = ["corners", "edges", "faces", "grazing", "near", "grazing_before", "inside", "plane",
         "surface"]


@pytest.mark.parametrize("kind", KINDS)
def test_cull_sound_on_lines(kind):
    """Lines at a box's corners, edges and faces from far away, at every
    scale of direction; grazing a face; from inside a box; from origins on a box plane
    with zero direction components (a NaN slab term); through a box with
    the surface hit before or behind it: no volume the plain override
    takes is culled, on all three scenes."""
    rng = np.random.default_rng(KINDS.index(kind))
    total_taken = 0
    for name in sorted(SCENES):
        scene = SCENES[name]()
        o, d, t_hit = _lines(kind, scene, rng)
        taken, _ = _assert_sound(scene, o, d, t_hit, f"{kind} on {name}")
        total_taken += taken
    if kind != "plane":
        assert total_taken > 100


CLAIM_KINDS = ["corners", "edges", "faces", "grazing", "near", "plane"]


@pytest.mark.parametrize("kind", CLAIM_KINDS)
def test_every_accepted_t_lies_in_the_widened_interval(kind):
    """The claim the cull rests on, held directly: on every lane the
    cull may skip (it does not graze a plane), every t that
    Möller–Trumbore accepts against a volume's triangles, in float32 by
    the kernel's operations (soa._mt_all), lies in [enter, exit], the
    slab interval of the volume's box widened by the lane's pad as the
    kernel computes it; on all three scenes."""
    rng = np.random.default_rng(100 + CLAIM_KINDS.index(kind))
    checked = 0
    for name in sorted(SCENES):
        scene = SCENES[name]()
        o, d, _ = _lines(kind, scene, rng)
        for v in range(scene.num_volumes):
            rows = scene.vol_tri_vol == v
            det, t, u, w = soa._mt_all(scene.vol_v0[rows], scene.vol_e1[rows],
                                       scene.vol_e2[rows], o, d)
            ok = soa._mt_valid(det, t, u, w, -torch.inf, torch.inf) & torch.isfinite(t)
            enter, exit_, swept = _box_span(scene, v, o, d)
            ok &= ~swept[None]
            out = ok & ((t < enter[None]) | (t > exit_[None]))
            assert not bool(out.any()), f"{kind} on {name}: {int(out.sum())} t's outside"
            checked += int(ok.sum())
    assert checked > 1000


def test_zero_direction_components_and_grazing_lanes():
    """A line with a zero direction component meets the widened box only
    where its origin lies in that axis's widened slab; a line in a
    boundary plane's orientation is swept whatever its segment."""
    scene = _rotated()
    c, h, _, _ = _box(scene, 0)
    d = Vec3(torch.zeros(3), torch.full((3,), 0.1), torch.full((3,), 0.9))
    ox = torch.tensor([float(c[0]), float(c[0] - h[0] - 0.5), float(c[0])])
    o = Vec3(ox, torch.full((3,), float(c[1])), torch.full((3,), float(c[2] - 5)))
    t_hit = torch.tensor([math.inf, math.inf, 5e-4])  # the last before T_MIN
    assert _box_open(scene, 0, o, d, t_hit).tolist() == [True, False, False]
    # along the rotated box's face: the same origins, now swept
    n1 = _box(scene, 0)[3][1]
    ax = torch.tensor([float(n1[2]), 0.0, -float(n1[0])]).float()
    dg = Vec3(*(ax[:, None].expand(3, 3)))
    assert _box_open(scene, 0, o, dg, t_hit).tolist() == [True, True, True]


# ------------------------------------------------- vol_probes (the tree)


def _one_sweep(ts):
    """vol_probes' selection, in float32: the VOL_KEEP smallest finite t's
    kept by the min/max insertion, t1 the first, t2 the first kept above
    t1 + 1e-4f, else a second sweep where a finite t was dropped.
    Returns (t1, t2, whether the second sweep ran)."""
    inf = np.float32(np.inf)
    k = [inf] * pk.VOL_KEEP
    dropped = False
    for t in ts:
        t = np.float32(t)
        if not (-inf < t < inf):
            continue
        for i in range(pk.VOL_KEEP):
            k[i], t = min(k[i], t), max(k[i], t)
        dropped = dropped or t < inf
    t1 = k[0]
    lo = np.float32(t1 + np.float32(1e-4))
    t2 = inf
    for i in range(pk.VOL_KEEP - 1, 0, -1):
        t2 = k[i] if k[i] > lo else t2
    second = bool(dropped and not t2 < inf)
    if second:
        t2 = min([np.float32(t) for t in ts if lo < np.float32(t) < inf], default=inf)
    return t1, t2, second


def _two_sweeps(ts):
    """vol_closest from -inf, then from t1 + 1e-4f (strict bounds)."""
    inf = np.float32(np.inf)
    f = [np.float32(t) for t in ts]
    t1 = min([t for t in f if -inf < t < inf], default=inf)
    lo = np.float32(t1 + np.float32(1e-4))
    return t1, min([t for t in f if lo < t < inf], default=inf)


@pytest.mark.parametrize("case", ["ties", "many", "random"])
def test_one_sweep_equals_two_sweeps(case):
    """Both probes from one sweep equal the two sweeps' floats: on t lists
    with ties and clusters inside 1e-4 of the first, with more valid t's
    than the sweep keeps, with inf and NaN entries."""
    rng = np.random.default_rng(["ties", "many", "random"].index(case))
    seconds = 0
    for _ in range(3000):
        base = np.float32(rng.choice([1e-3, 0.5, 1.0, 37.0, 1e4]) * rng.uniform(0.5, 2))
        if case == "ties":
            n = rng.integers(1, 9)
            ts = base + np.float32(1e-4) * rng.choice([0, 0, 0.5, 1, 1.0001, 2], n)
        elif case == "many":
            n = rng.integers(5, 13)
            ts = base + np.float32(1e-5) * rng.integers(0, 12, n)
            if rng.uniform() < 0.5:
                ts = np.append(ts, base + rng.uniform(0.01, 10))
        else:
            n = rng.integers(0, 13)
            ts = base * rng.uniform(-2, 3, n)
        ts = list(np.asarray(ts, np.float32))
        if rng.uniform() < 0.2:
            ts.insert(rng.integers(0, len(ts) + 1), np.float32(np.inf))
        if rng.uniform() < 0.1:
            ts.insert(rng.integers(0, len(ts) + 1), np.float32(np.nan))
        rng.shuffle(ts)
        t1, t2, second = _one_sweep(ts)
        w1, w2 = _two_sweeps(ts)
        assert (t1, t2) == (w1, w2) or (np.isinf(t1) and np.isinf(w1)), (ts, t1, t2, w1, w2)
        col = torch.tensor([[x if np.isfinite(x) else np.inf] for x in ts + [np.inf]],
                           dtype=torch.float32)
        m1, m2, again = _probes_mirror(col)
        assert (float(m1), float(m2), bool(again)) == (t1, t2, second) or np.isinf(t1)
        seconds += second
    if case != "random":
        assert seconds > 100  # the fallback sweep is exercised
    else:
        assert seconds < 300


E2_KINDS = ["corners", "edges", "faces", "grazing", "inside", "plane"]


@pytest.mark.parametrize("kind", E2_KINDS)
def test_one_sweep_on_lines(kind):
    """vol_probes' mirror gives the two sweeps' t1 and t2 on the
    Möller–Trumbore t's of lines at the boxes' corners (ties of up to six
    triangles), edges, faces, grazing faces, from inside and on box
    planes, on the three scenes and a volume sphere's 36 triangles."""
    rng = np.random.default_rng(200 + E2_KINDS.index(kind))
    lanes = 0
    for scene in [SCENES[name]() for name in sorted(SCENES)] + [_sphere()]:
        o, d, _ = _lines(kind, scene, rng)
        for v in range(scene.num_volumes):
            ts = _mt_ts(scene, v, o, d)
            p1, p2, _ = _probes_mirror(ts)
            s1, s2 = _sweeps(ts)
            assert torch.equal(p1, s1) and torch.equal(p2, s2)
            lanes += int(torch.isfinite(s1).sum())
    assert lanes > 1000
