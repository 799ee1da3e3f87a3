"""Fused PT megakernel: wrappers, table packing and plain versions.

Counterpart of ``bpt_tpu/ops/pallas/pt_kernel.py``.  ``pt_megakernel``
(rays in) and ``pt_megakernel_pixels`` (in-kernel raygen + spp loop) take
the same arguments and return the same outputs as their Pallas
counterparts, except that the key is a ``(k1, k2)`` pair of ints
(``core.rng.prng_key``) and the counters are exact int64.

Two modes, as bpt_tpu's kernel has (``use_clusters``): a scene of at most
``MAX_TRIS`` triangles sweeps them all from shared memory; a larger scene
with a BVH walks it (the counterpart of the clustered mode), with the walk
tables of ``ops/kernels/pt_wave.py::walk_tables``.  The counters are the
hit provider's: node visits and box hits are 0 in the sweep, which counts
T triangle tests a closest hit and one accepted test a hit; the walk
counts as ``closest_bvh`` does.

Both modes run one sample a work item on a persistent grid
(``csrc/walk_sched.cuh``; the brute mode's lanes a flat bounce loop whose
warps refill their free lanes): in pixels mode with more than one stratum
each launch writes its samples' radiance stratum by stratum and the
wrapper adds them into the pixel totals in stratum order
(``walk_launches``, ``strata_sum``: ``csrc/strata_sum.cu``), over as many
launches as ``stratum_ranges`` plans; a call can thus launch the kernel
more than once, and counts each launch.

Dispatch is by device: a CPU tensor takes the plain PyTorch version (the
``models.pt`` wavefront on the same threefry stream, over
``ops.soa.bvh_closest`` on a scene over ``MAX_TRIS`` triangles); a CUDA
tensor launches ``csrc/pt_megakernel.cu`` or raises.  Each wrapper counts
its launches in ``<wrapper>.launches``, and those of the volume mode (the
``_vol`` kernels, which a scene with constant-density volumes takes) also
in ``<wrapper>.vol_launches``; the plain versions count their calls in
``<plain>.calls``.
"""

from __future__ import annotations

import functools

import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models.camera import CameraConstants, generate_rays
from bpt_tpu_torch.models.pt import (
    NU,
    array_uniforms_fn,
    kernel_stream_uniforms_fn,
    path_trace_radiance,
)
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.scene.types import SceneTensors, per_scene

MAX_TRIS = 512
MAX_MATS = 16
MAX_LIGHTS = 16
TRI_STRIDE = 13  # v0(3) e1(3) e2(3) n(3) mat(1)
MAT_STRIDE = 6  # mtype, albedo(3), fuzz, ior
LGT_STRIDE = 13  # v0(3) e1(3) e2(3) n(3) area(1)
# constant-density volumes (bpt_tpu/ops/pallas/pt_kernel.py:62-65)
MAX_VOLS = 4
MAX_VOL_TRIS = 64
VOL_STRIDE = 10  # v0(3) e1(3) e2(3) owning-volume id
VOLM_STRIDE = 2  # neg_inv_density, phase material id
VOL_KEEP = 4  # the valid t's the override's one sweep keeps (csrc/volume.cuh)


INTEGRATORS = ("pt", "bdpt", "bdpt-mis")


def megakernel_reject_reason(scene: SceneTensors, integrator: str = "pt") -> str:
    """Why the PT or BDPT megakernel cannot render ``scene`` ('' if it
    can); both take the same scenes: at most ``MAX_TRIS`` triangles, or a
    BVH to walk, within ``shade_reject_reason``'s tables.  bpt_tpu's
    single-table budget of its clustered mode (clusters.py:92-102, TPU
    SMEM) has no counterpart: the walk reads the BVH from device memory.
    Textured scenes go to the wave or the stratum loop, as in bpt_tpu
    (pt_kernel.py:1025-1027)."""
    if integrator not in INTEGRATORS:
        return f"unknown integrator {integrator!r} (not one of {', '.join(INTEGRATORS)})"
    if scene.num_tris > MAX_TRIS and not scene.use_bvh:
        return f"{scene.num_tris} tris > MAX_TRIS={MAX_TRIS} and no BVH to walk"
    if scene.has_textures:
        return "scene has textures (the megakernels take none: pt_wave and the jnp estimators do)"
    return shade_reject_reason(scene)


def use_walk(scene: SceneTensors) -> bool:
    """The megakernels walk the scene's BVH (bpt_tpu's ``use_clusters``)."""
    return scene.num_tris > MAX_TRIS


def shade_reject_reason(scene: SceneTensors) -> str:
    """Why the shade's tables (``pack_shade_tables``), which the
    megakernels and the wave kernel read, cannot hold ``scene``: the wave
    kernel's reason (bpt_tpu's ``wave_reject_reason``), which lets textured
    scenes through."""
    if scene.num_lights > MAX_LIGHTS:
        return f"{scene.num_lights} lights > MAX_LIGHTS={MAX_LIGHTS}"
    m = int(scene.materials.mtype.shape[0])
    if m > MAX_MATS:
        return f"{m} materials > MAX_MATS={MAX_MATS}"
    if scene.num_volumes > MAX_VOLS:
        return f"{scene.num_volumes} volumes > MAX_VOLS={MAX_VOLS}"
    if scene.num_volumes and int(scene.vol_v0.shape[0]) > MAX_VOL_TRIS:
        return (f"{int(scene.vol_v0.shape[0])} volume boundary tris > "
                f"MAX_VOL_TRIS={MAX_VOL_TRIS}")
    if scene.dtype != torch.float32:
        return (f"dtype {scene.dtype} != float32 (the CUDA kernels take "
                "float32; render() takes float64 through the stratum loop)")
    return ""


def pack_shade_tables(scene: SceneTensors):
    """The shade's padded tables on the scene's device: (mat
    f32[MAX_MATS*6], lgt f32[MAX_LIGHTS*13 + 3] with the background at the
    tail).  The PT megakernel and the wave kernel read both."""
    M = int(scene.materials.mtype.shape[0])
    L = scene.num_lights
    kw = dict(dtype=torch.float32, device=scene.device)
    mats = scene.materials
    mat = torch.zeros((MAX_MATS, MAT_STRIDE), **kw)
    mat[:M] = torch.stack([mats.mtype.to(torch.float32),
                           *mats.albedo.to(torch.float32).unbind(1),
                           mats.fuzz.to(torch.float32),
                           mats.ior.to(torch.float32)], dim=1)
    lgt = torch.zeros((MAX_LIGHTS, LGT_STRIDE), **kw)
    lgt[:L] = torch.cat([scene.light_v0, scene.light_e1, scene.light_e2,
                         scene.light_normal, scene.light_area[:, None]],
                        dim=1).to(torch.float32)
    return mat.reshape(-1), torch.cat([lgt.reshape(-1), scene.background.to(torch.float32)])


def _pack_tables(scene: SceneTensors):
    """Padded kernel tables on the scene's device:
    (meta i32[8], tri f32[MAX_TRIS*13], mat f32[MAX_MATS*6],
    lgt f32[MAX_LIGHTS*13 + 3] with the background at the tail).  A scene
    the kernels walk gets one zero row for tri, which they do not read (as
    bpt_tpu's clustered mode does)."""
    T = scene.num_tris
    M = int(scene.materials.mtype.shape[0])
    L = scene.num_lights
    rows = 1 if use_walk(scene) else MAX_TRIS
    tri = torch.zeros((rows, TRI_STRIDE), dtype=torch.float32, device=scene.device)
    if not use_walk(scene):
        tri[:T] = torch.cat([scene.v0, scene.e1, scene.e2, scene.normal,
                             scene.mat_id[:, None].to(scene.dtype)], dim=1).to(torch.float32)
    VT = int(scene.vol_v0.shape[0]) if scene.num_volumes else 0
    meta = torch.tensor([T, M, L, 0, 0, 0, scene.num_volumes, VT],
                        dtype=torch.int32, device=scene.device)
    return (meta, tri.reshape(-1), *pack_shade_tables(scene))


@per_scene
def pack_vol_tables(scene: SceneTensors):
    """The kernels' volume tables on the scene's device
    (bpt_tpu/ops/pallas/pt_kernel.py:1098-1114), packed once a scene:
    (vol f32[MAX_VOL_TRIS*10], the boundary triangles v0, e1, e2 and the
    owning volume, owner -1 on the pad rows; volm f32[MAX_VOLS*2], each
    volume's -1/density and phase material)."""
    VT = int(scene.vol_v0.shape[0])
    kw = dict(dtype=torch.float32, device=scene.device)
    vol = torch.zeros((MAX_VOL_TRIS, VOL_STRIDE), **kw)
    vol[:VT] = torch.cat([scene.vol_v0, scene.vol_e1, scene.vol_e2,
                          scene.vol_tri_vol[:, None].to(scene.dtype)], dim=1).to(torch.float32)
    vol[VT:, 9] = -1.0
    volm = torch.zeros((MAX_VOLS, VOLM_STRIDE), **kw)
    V = int(scene.vol_neg_inv_density.shape[0])
    volm[:V] = torch.stack([scene.vol_neg_inv_density.to(torch.float32),
                            scene.vol_mat.to(torch.float32)], dim=1)
    return vol.reshape(-1), volm.reshape(-1)


def camera_table(cc: CameraConstants) -> torch.Tensor:
    """CameraConstants -> [13] f32 (pixel00, du, dv, center, 1/sqrt_spp)."""
    return torch.cat([
        cc.pixel00.to(torch.float32), cc.du.to(torch.float32),
        cc.dv.to(torch.float32), cc.center.to(torch.float32),
        torch.tensor([1.0 / cc.sqrt_spp], dtype=torch.float32,
                     device=cc.center.device),
    ])


# ---------------------------------------------------------------- plain


def _counters(stats):
    return stats.rays_traced, torch.stack(
        [stats.node_visits, stats.aabb_hits, stats.tri_tests, stats.tri_hits])


def _scatter_active(rad, idx, B):
    out = torch.zeros((B, 3), dtype=rad.dtype, device=rad.device)
    out[idx] = rad
    return out[:, 0], out[:, 1], out[:, 2]


def pt_megakernel_plain(scene, o: Vec3, d: Vec3, ray_ids, key, depth: int,
                        uniforms=None):
    """Plain version of ``pt_megakernel``: the ``models.pt`` wavefront over
    the active lanes (ray_ids >= 0), fed the injected ``uniforms``
    [depth*(NU+V), B] or the kernel's threefry stream."""
    pt_megakernel_plain.calls += 1
    B = ray_ids.shape[0]
    nu = NU + scene.num_volumes
    idx = torch.nonzero(ray_ids >= 0).squeeze(1)
    origins = torch.stack([o.x, o.y, o.z], dim=-1)[idx]
    dirs = torch.stack([d.x, d.y, d.z], dim=-1)[idx]
    if uniforms is None:
        ufn = kernel_stream_uniforms_fn(key, ray_ids[idx], origins.dtype, scene.num_volumes)
    else:
        ufn = array_uniforms_fn(
            uniforms.reshape(depth, nu, B).permute(2, 0, 1)[idx])
    rad, stats = path_trace_radiance(scene, origins, dirs, depth, ufn, plain=True)
    return (*_scatter_active(rad, idx, B), *_counters(stats))


pt_megakernel_plain.calls = 0


def _camera_from_table(cam13: torch.Tensor) -> CameraConstants:
    sqrt_cam = int(round(1.0 / float(cam13[12])))
    zero = torch.zeros_like(cam13[0:3])
    return CameraConstants(center=cam13[9:12], pixel00=cam13[0:3],
                           du=cam13[3:6], dv=cam13[6:9], defocus_u=zero,
                           defocus_v=zero, sqrt_spp=sqrt_cam)


def pt_megakernel_pixels_plain(scene, i, j, sx, sy, ray_ids, cam13, key,
                               depth: int, spp_loop: int = 1,
                               sqrt_spp: int = 1):
    """Plain version of ``pt_megakernel_pixels``: for each stratum in
    order, the kernel's jitter stream, ``generate_rays``, the wavefront on
    ``fold_in(key, 1)``, and the sample added to the pixel total."""
    pt_megakernel_pixels_plain.calls += 1
    B = ray_ids.shape[0]
    idx = torch.nonzero(ray_ids >= 0).squeeze(1)
    cc = _camera_from_table(cam13)
    key_pt = rng.fold_in(key, 1)
    iv, jv = i[idx], j[idx]
    ids = ray_ids[idx].to(torch.int64)
    if spp_loop == 1:
        strata = [(ids, sx[idx], sy[idx])]
    else:
        spp = sqrt_spp * sqrt_spp
        strata = [(ids * spp + s, torch.full_like(iv, float(s % sqrt_spp)),
                   torch.full_like(iv, float(s // sqrt_spp)))
                  for s in range(spp)]
    total = None
    rays = torch.zeros((), dtype=torch.int64, device=i.device)
    extra = torch.zeros(4, dtype=torch.int64, device=i.device)
    for rid, s_i, s_j in strata:
        u0, u1 = rng.raygen_jitter(key, rid)
        zero = torch.zeros_like(u0)
        origins, dirs = generate_rays(cc, iv, jv, s_i, s_j,
                                      torch.stack([u0, u1, zero, zero], -1))
        rad, stats = path_trace_radiance(
            scene, origins, dirs, depth,
            kernel_stream_uniforms_fn(key_pt, rid, origins.dtype, scene.num_volumes),
            plain=True)
        total = rad if total is None else total + rad
        r, e = _counters(stats)
        rays = rays + r
        extra = extra + e
    return (*_scatter_active(total, idx, B), rays, extra)


pt_megakernel_pixels_plain.calls = 0


# ---------------------------------------------------------------- kernel


def _checked(t, shape, dev, what, dtype=torch.float32):
    """The kernel takes f32 tensors of one shape on the lanes' device."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{what}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"expected {dtype} {shape} on {dev}")
    return t.contiguous()


def key_words(keys, dev) -> torch.Tensor:
    """uint32 key words as the int32 bit patterns the kernels read."""
    return torch.tensor([k - (1 << 32) if k >= (1 << 31) else k for k in keys],
                        dtype=torch.int32, device=dev)


def _lane_inputs(scene, integrator, ins, ray_ids, keys, cam):
    """Checks and uploads what a megakernel launch takes besides its own
    tables: (device, B, six lane-input tensors, int32 ids, uint32 keys,
    camera table).  Raises on what the kernels do not take."""
    dev = ray_ids.device
    reason = megakernel_reject_reason(scene, integrator)
    if reason:
        raise ValueError(f"{integrator} megakernel cannot render this scene: {reason}")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device} but lanes on {dev}")
    if ray_ids.dtype not in (torch.int32, torch.int64) or ray_ids.dim() != 1:
        raise ValueError(f"ray_ids: {ray_ids.dtype} {tuple(ray_ids.shape)}, "
                         "expected a 1-D int32 or int64 tensor")
    B = int(ray_ids.shape[0])
    ins = [_checked(x, (B,), dev, "lane input") for x in ins]
    ins += [ins[0]] * (6 - len(ins))  # unused pointers in pixels mode
    rid = ray_ids.to(torch.int32).contiguous()
    keys_t = key_words(keys, dev)
    cam_t = (torch.zeros(13, dtype=torch.float32, device=dev) if cam is None
             else _checked(cam, (13,), dev, "camera table"))
    return dev, B, ins, rid, keys_t, cam_t


def vol_args(scene):
    """(V, VT, vol, volm) of a launch's volume arguments: the volumes,
    their boundary triangles and device pointers to ``pack_vol_tables``
    (kept while the scene lives); (0, 0, None, None) without volumes,
    whose launches take the volume-free kernels."""
    if not scene.num_volumes:
        return 0, 0, None, None
    vol, volm = pack_vol_tables(scene)
    return scene.num_volumes, int(scene.vol_v0.shape[0]), vol.data_ptr(), volm.data_ptr()


def walk_args(scene):
    """(N, nodes, tris, mat_id) of the walk mode's scene arguments, or
    (0, None, None, None) in the brute mode."""
    if not use_walk(scene):
        return 0, None, None, None
    from bpt_tpu_torch.ops.kernels.pt_wave import walk_tables  # imports this module

    nodes, tris = walk_tables(scene)
    mat_id = scene.mat_id.to(torch.int32).contiguous()
    return int(nodes.shape[0]), nodes.data_ptr(), tris.data_ptr(), mat_id


# The per-sample radiance a pixels-mode launch may hold, [3, k1 - k0, B] f32
# (stratum_ranges)
STRATA_BYTES = 256 << 20
WALK_BLOCK = 128  # threads a block of the persistent megakernels (csrc BLOCK)


def stratum_ranges(B: int, spp: int, budget=None) -> list:
    """The persistent megakernels' launches of a pixels-mode call over B
    lanes and spp strata: stratum ranges [k0, k1) in order, each as many
    strata as keep its per-sample radiance, 12 bytes a sample, within
    ``budget`` bytes (``STRATA_BYTES``); one stratum a range where even one
    is over it."""
    budget = STRATA_BYTES if budget is None else budget
    per = max(1, budget // (12 * max(1, B)))
    return [(k0, min(spp, k0 + per)) for k0 in range(0, spp, per)]


def walk_grid(resident_blocks, items: int) -> int:
    """Persistent blocks of a launch of ``items`` work items (samples of a
    megakernel, lanes of a brute-force hit kernel), 128 threads a block: as
    many as the card holds at once (``resident_blocks()``, the C occupancy
    query), and no more than the items fill."""
    blocks = resident_blocks()
    if blocks <= 0:
        raise RuntimeError(f"persistent kernel occupancy query failed: CUDA error {-blocks}")
    return max(1, min(blocks, -(-items // WALK_BLOCK)))


def strata_sum_plain(rows, tot, first: bool):
    """Plain version of ``strata_sum``: one elementwise add a stratum."""
    strata_sum_plain.calls += 1
    if first:
        tot.zero_()
    for k in range(rows.shape[1]):
        tot += rows[:, k]
    return tot


strata_sum_plain.calls = 0


def strata_sum(rows, tot, first: bool):
    """Adds a launch's per-sample radiance ``rows`` [3, nk, B] into the lane
    totals ``tot`` [3, B] (from zeros when ``first``) one stratum after
    another, the float-add sequence ((tot + s0) + s1) + ... of a lane
    summing its strata in order; returns ``tot``.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``csrc/strata_sum.cu`` or
    raises."""
    if _device_of(rows).type == "cpu":
        return strata_sum_plain(rows, tot, first)
    dev = rows.device
    nk, B = (int(rows.shape[1]), int(rows.shape[2])) if rows.dim() == 3 else (0, 0)
    _checked(rows, (3, nk, B), dev, "rows")
    _checked(tot, (3, B), dev, "tot")
    if nk < 1 or not (rows.is_contiguous() and tot.is_contiguous()):
        raise ValueError("strata_sum takes contiguous rows [3, nk >= 1, B] and tot [3, B]")
    with torch.cuda.device(dev):
        code = build.load_library().bpt_strata_sum(
            int(first), B, nk, rows.data_ptr(), tot.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "strata_sum")
    strata_sum.launches += 1
    return tot


strata_sum.launches = 0


def walk_launches(B: int, pixels: bool, spp: int, launch, dev) -> torch.Tensor:
    """The persistent megakernels' launches of one call: one over B samples,
    or in pixels mode with spp > 1 one a stratum range.  ``launch(k0, nk,
    out)`` runs the kernel on [k0, k0 + nk) into out [3, nk, B] on ``dev``.
    Returns the lane totals [3, B]: each range's rows added one stratum
    after another from zeros (``strata_sum``), the float-add sequence
    ((0 + s0) + s1) + ... of a lane summing its strata in order, so no
    split changes a bit."""
    if not pixels or spp == 1:
        out = torch.empty((3, 1, B), dtype=torch.float32, device=dev)
        launch(0, 1, out)
        return out[:, 0]
    tot = torch.empty((3, B), dtype=torch.float32, device=dev)
    for k0, k1 in stratum_ranges(B, spp):
        rows = torch.empty((3, k1 - k0, B), dtype=torch.float32, device=dev)
        launch(k0, k1 - k0, rows)
        strata_sum(rows, tot, first=k0 == 0)
    return tot


def _launch(wrapper, scene, ins, ray_ids, keys, depth, pixels, cam=None,
            ubuf=None, spp_loop=1, sqrt_spp=1):
    dev, B, ins, rid, keys_t, cam_t = _lane_inputs(scene, "pt", ins, ray_ids, keys, cam)
    _, tri, mat, lgt = _pack_tables(scene)
    N, nodes, tris, mat_id = walk_args(scene)
    if ubuf is not None:
        ubuf = _checked(ubuf, (depth * (NU + scene.num_volumes), B), dev, "uniforms")
    counters = torch.zeros(5, dtype=torch.int64, device=dev)
    lib = build.load_library()
    V, VT, vol, volm = vol_args(scene)
    blocks = functools.partial(lib.bpt_pt_blocks, int(N > 0), int(V > 0))

    def launch(k0, nk, out):
        nxt = torch.zeros(1, dtype=torch.int32 if N else torch.int64, device=dev)
        code = lib.bpt_pt_megakernel(
            int(pixels), B, scene.num_tris, scene.num_lights, int(depth),
            int(spp_loop), int(sqrt_spp), N, k0, nk, walk_grid(blocks, B * nk),
            tri.data_ptr(), nodes, tris, None if mat_id is None else mat_id.data_ptr(),
            mat.data_ptr(), lgt.data_ptr(), keys_t.data_ptr(),
            cam_t.data_ptr(), *(x.data_ptr() for x in ins), rid.data_ptr(),
            None if ubuf is None else ubuf.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            counters.data_ptr(), nxt.data_ptr(), V, VT, vol, volm, stream)
        build.check(code, "pt_megakernel")
        wrapper.launches += 1
        if V:
            wrapper.vol_launches += 1

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = walk_launches(B, pixels, spp_loop, launch, dev)
    return out[0], out[1], out[2], counters[0], counters[1:]


def _device_of(t) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda tensors, not {dev}")
    return dev


def pt_megakernel(scene: SceneTensors, o: Vec3, d: Vec3, ray_ids, key,
                  depth: int, uniforms=None):
    """Whole PT loop from given rays.  ray_ids [B] int (negative = inactive
    lane); uniforms: optional [depth*(NU+V), B] f32 injected draws, V the
    scene's volumes.

    Returns (rad_x, rad_y, rad_z [B] f32, rays_traced int64,
    extra int64[4] = (node_visits, aabb_hits, tri_tests, tri_hits))."""
    if _device_of(ray_ids).type == "cpu":
        return pt_megakernel_plain(scene, o, d, ray_ids, key, depth, uniforms)
    return _launch(pt_megakernel, scene, [o.x, o.y, o.z, d.x, d.y, d.z], ray_ids,
                   rng.subkeys(key, NU + scene.num_volumes), depth, pixels=False,
                   ubuf=uniforms)


pt_megakernel.launches = pt_megakernel.vol_launches = 0


def pt_megakernel_pixels(scene: SceneTensors, i, j, sx, sy, ray_ids, cam13,
                         key, depth: int, spp_loop: int = 1,
                         sqrt_spp: int = 1):
    """Fully fused PT: in-kernel ray generation + trace.  i, j: [B] pixel
    coords; sx, sy: [B] stratum (ignored when spp_loop > 1); ray_ids [B]:
    the absolute sample id pix*spp+s when spp_loop == 1, else the PIXEL id,
    whose strata all run in-kernel; negative = inactive.  cam13 from
    camera_table(); key: the base render key (streams 0/1 fold inside).

    Returns (rad_x, rad_y, rad_z [B], rays_traced, extra int64[4])."""
    if _device_of(ray_ids).type == "cpu":
        return pt_megakernel_pixels_plain(scene, i, j, sx, sy, ray_ids, cam13,
                                          key, depth, spp_loop, sqrt_spp)
    return _launch(pt_megakernel_pixels, scene, [i, j, sx, sy], ray_ids,
                   rng.subkeys_with_raygen(key, NU + scene.num_volumes), depth, pixels=True,
                   cam=cam13, spp_loop=spp_loop, sqrt_spp=sqrt_spp)


pt_megakernel_pixels.launches = pt_megakernel_pixels.vol_launches = 0
