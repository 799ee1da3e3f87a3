"""Fused BDPT megakernel: wrappers, table packing and plain versions.

Counterpart of ``bpt_tpu/ops/pallas/bdpt_kernel.py``.  ``bdpt_megakernel``
(rays in) and ``bdpt_megakernel_pixels`` (in-kernel raygen + spp loop)
take the same arguments and return the same outputs as their Pallas
counterparts, except that the key is a ``(k1, k2)`` pair of ints
(``core.rng.prng_key``) and the counters are exact int64:
``(rad_x, rad_y, rad_z, rays_traced, shadow_rays, extra[4])`` with
``extra = (node_visits, aabb_hits, tri_tests, tri_hits)``.

Two modes, as bpt_tpu's kernel has (``use_clusters``): a scene of at most
``MAX_TRIS`` triangles sweeps them all from shared memory; a larger scene
with a BVH walks it for the closest hits and the shadow rays (the
counterpart of the clustered mode).  The counters follow the Pallas
kernel in what they count and the port's walk in how: the sweep charges
T triangle tests a traced bounce and T a connection that reaches the
shadow any-hit, and one accepted test a hit; the walk charges every node
visit, box hit and triangle test of the closest and the shadow walks, and
the accepted tests of the closest walks only (bpt_tpu's clustered kernel
charges its shadow traversals to all but the triangle hits,
bdpt_kernel.py:183-186, 239-250).  Both modes schedule as the PT
kernel's walk mode does (``pt_kernel.walk_launches``: one sample a work
item on a persistent grid, stratum ranges in pixels mode), with the vertex
scratch of their resident threads (``walk_scratch_bytes``,
``scratch_shape``).  The walk mode shares each warp's shadow walks across
its lanes; the brute mode sweeps each shadow ray where it comes up.

Dispatch is by device: a CPU tensor takes the plain PyTorch version (the
``models.bdpt`` wavefront on the kernel's threefry stream or on injected
uniforms, over ``ops.soa.bvh_closest`` / ``bvh_any`` on a scene over
``MAX_TRIS`` triangles, counting as the kernel does); a CUDA tensor
launches ``csrc/bdpt_megakernel.cu`` or raises.  A scene with
constant-density volumes takes the kernel's volume mode (its ``_vol``
kernels: the free-flight override after each closest hit of a trace, NT + V
slots a trace bounce, the volume tables of ``pt_kernel.pack_vol_tables``).
Each wrapper counts its launches in ``<wrapper>.launches`` (those of the
volume mode also in ``<wrapper>.vol_launches``); the plain versions count
their calls in ``<plain>.calls``.
"""

from __future__ import annotations

import functools

import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import bdpt as mb
from bpt_tpu_torch.models.camera import generate_rays
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels.pt_kernel import (
    MAX_LIGHTS,
    WALK_BLOCK,
    _camera_from_table,
    _checked,
    _device_of,
    _lane_inputs,
    _pack_tables,
    _scatter_active,
    stratum_ranges,
    vol_args,
    walk_args,
    walk_grid,
    walk_launches,
)
from bpt_tpu_torch.scene.types import SceneTensors

MAX_DEPTH = 80  # the kernel's bound on the runtime depth
VTX_STRIDE = 14  # p(3) n(3) thr(3) emit(3) mat(1) flags(1)
VTX_STRIDE_MIS = 17  # + pfwd, rat2, the suffix sum to slot 0
NT, NLS = mb.NT, mb.NLS
n_uniform_slots = rng.n_uniform_slots


def _pack_tables_bdpt(scene: SceneTensors):
    """The PT tables with the total light area and the per-light material
    ids appended at the light table's tail (after the background)."""
    meta, tri, mat, lgt = _pack_tables(scene)
    lmat = torch.zeros(MAX_LIGHTS, dtype=torch.float32, device=scene.device)
    lmat[:scene.num_lights] = scene.light_mat.to(torch.float32)
    lgt = torch.cat([lgt, scene.light_total_area.to(torch.float32).reshape(1), lmat])
    return meta, tri, mat, lgt


def _check_depth(depth: int) -> None:
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"BDPT depth {depth} outside 1..{MAX_DEPTH}")


# ---------------------------------------------------------------- plain


def _buffer_uniforms(ubuf, depth: int, n_vols: int = 0):
    """Injected rows [n_uniform_slots(depth, n_vols), N] -> the uniform
    sources of models.bdpt.bdpt_radiance (the kernel's slot layout: NT +
    n_vols rows a trace bounce)."""
    ntv = NT + n_vols
    lt0 = depth * ntv + NLS

    def cam_fn(b, n):
        return list(ubuf[b * ntv:b * ntv + n])

    def light_fn(b, n):
        return list(ubuf[lt0 + b * ntv:lt0 + b * ntv + n])

    return cam_fn, list(ubuf[depth * ntv:lt0]), light_fn


def _radiance(scene, origins, dirs, depth, sources, mis):
    rad, st = mb.bdpt_radiance(scene, origins, dirs, depth, *sources, mis=mis,
                               count_shadow_tests=True, plain=True)
    extra = torch.stack([st.node_visits, st.aabb_hits, st.tri_tests, st.tri_hits])
    return rad, st.rays_traced, st.shadow_rays, extra


def bdpt_megakernel_plain(scene, o: Vec3, d: Vec3, ray_ids, key, depth: int,
                          uniforms=None, mis: bool = False):
    """Plain version of ``bdpt_megakernel``: the ``models.bdpt`` wavefront
    over the active lanes (ray_ids >= 0), fed the injected ``uniforms``
    [n_uniform_slots(depth, V), B] or the kernel's threefry stream."""
    bdpt_megakernel_plain.calls += 1
    _check_depth(depth)
    B = ray_ids.shape[0]
    idx = torch.nonzero(ray_ids >= 0).squeeze(1)
    origins = torch.stack([o.x, o.y, o.z], dim=-1)[idx]
    dirs = torch.stack([d.x, d.y, d.z], dim=-1)[idx]
    if uniforms is None:
        sources = rng.bdpt_kernel_stream_uniforms_fn(key, ray_ids[idx], depth,
                                                     origins.dtype, scene.num_volumes)
    else:
        sources = _buffer_uniforms(uniforms[:, idx], depth, scene.num_volumes)
    rad, rays, shadow, extra = _radiance(scene, origins, dirs, depth, sources, mis)
    return (*_scatter_active(rad, idx, B), rays, shadow, extra)


bdpt_megakernel_plain.calls = 0


def stratum_plain(scene, i, j, pix_ids, cam13, key, depth: int, sqrt_spp: int,
                  k, mis: bool = False):
    """Stratum k of ``bdpt_megakernel_pixels_plain`` on the active lanes
    (pix_ids >= 0): (radiance [n_active, 3], rays, shadow rays, extra) of
    the samples pix*spp + k, on the kernel's jitter and stream.  ``k``: one
    stratum for every lane, or a [B] int tensor, each lane's own."""
    idx = torch.nonzero(pix_ids >= 0).squeeze(1)
    iv, jv = i[idx], j[idx]
    kv = k[idx].to(torch.int64) if torch.is_tensor(k) else torch.full_like(idx, k)
    rid = pix_ids[idx].to(torch.int64) * (sqrt_spp * sqrt_spp) + kv
    u0, u1 = rng.bdpt_raygen_jitter(key, rid)
    zero = torch.zeros_like(u0)
    origins, dirs = generate_rays(
        _camera_from_table(cam13), iv, jv, (kv % sqrt_spp).to(iv.dtype),
        (kv // sqrt_spp).to(iv.dtype), torch.stack([u0, u1, zero, zero], -1))
    sources = rng.bdpt_kernel_stream_uniforms_fn(key, rid, depth, origins.dtype,
                                                 scene.num_volumes)
    return _radiance(scene, origins, dirs, depth, sources, mis)


def bdpt_megakernel_pixels_plain(scene, i, j, pix_ids, cam13, key, depth: int,
                                 sqrt_spp: int, mis: bool = False):
    """Plain version of ``bdpt_megakernel_pixels``: for each stratum in
    order, the kernel's jitter stream, ``generate_rays``, the wavefront on
    the kernel's stream, and the sample added to the pixel total."""
    bdpt_megakernel_pixels_plain.calls += 1
    _check_depth(depth)
    B = pix_ids.shape[0]
    idx = torch.nonzero(pix_ids >= 0).squeeze(1)
    total = None
    rays = torch.zeros((), dtype=torch.int64, device=i.device)
    shadow = torch.zeros((), dtype=torch.int64, device=i.device)
    extra = torch.zeros(4, dtype=torch.int64, device=i.device)
    for s in range(sqrt_spp * sqrt_spp):
        rad, r, sh, e = stratum_plain(scene, i, j, pix_ids, cam13, key, depth, sqrt_spp, s,
                                      mis)
        total = rad if total is None else total + rad
        rays, shadow, extra = rays + r, shadow + sh, extra + e
    return (*_scatter_active(total, idx, B), rays, shadow, extra)


bdpt_megakernel_pixels_plain.calls = 0


# ---------------------------------------------------------------- kernel


def walk_scratch_bytes(threads: int, depth: int, mis: bool) -> int:
    """Bytes of the vertex scratch, [threads][2][depth*stride] f32: a
    resident thread's camera and light vertex records."""
    return 2 * depth * (VTX_STRIDE_MIS if mis else VTX_STRIDE) * 4 * threads


def scratch_shape(B: int, spp: int, resident_blocks, depth: int, mis: bool):
    """The vertex scratch [threads, 2, depth*stride] of one call over B
    lanes and spp strata (1 in rays mode), both modes: the resident threads
    of its largest launch (the first stratum range's), shared by all of
    its launches.  ``resident_blocks()``: the kernel's occupancy query."""
    k0, k1 = stratum_ranges(B, spp)[0]
    stride = VTX_STRIDE_MIS if mis else VTX_STRIDE
    return walk_grid(resident_blocks, B * (k1 - k0)) * WALK_BLOCK, 2, depth * stride


def _launch(wrapper, scene, ins, ray_ids, keys, depth, mis, pixels, cam=None,
            ubuf=None, sqrt_spp=1):
    _check_depth(depth)
    dev, B, ins, rid, keys_t, cam_t = _lane_inputs(
        scene, "bdpt-mis" if mis else "bdpt", ins, ray_ids, keys, cam)
    _, tri, mat, lgt = _pack_tables_bdpt(scene)
    N, nodes, tris, mat_id = walk_args(scene)
    V, VT, vol, volm = vol_args(scene)
    if ubuf is not None:
        ubuf = _checked(ubuf, (n_uniform_slots(depth, V), B), dev, "uniforms")
    spp = sqrt_spp * sqrt_spp if pixels else 1
    counters = torch.zeros(6, dtype=torch.int64, device=dev)
    lib = build.load_library()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        blocks = functools.partial(lib.bpt_bdpt_blocks, int(N > 0), int(V > 0))
        vtx = torch.empty(scratch_shape(B, spp, blocks, depth, mis), dtype=torch.float32,
                          device=dev)

        def launch(k0, nk, out):
            nxt = torch.zeros(1, dtype=torch.int32, device=dev)
            code = lib.bpt_bdpt_megakernel(
                int(pixels), int(mis), B, scene.num_tris, scene.num_lights,
                int(depth), int(sqrt_spp), len(keys), N, k0, nk, walk_grid(blocks, B * nk),
                tri.data_ptr(), nodes, tris, None if mat_id is None else mat_id.data_ptr(),
                mat.data_ptr(), lgt.data_ptr(), keys_t.data_ptr(),
                cam_t.data_ptr(), *(x.data_ptr() for x in ins), rid.data_ptr(),
                None if ubuf is None else ubuf.data_ptr(), vtx.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                counters.data_ptr(), nxt.data_ptr(), V, VT, vol, volm, stream)
            build.check(code, "bdpt_megakernel")
            wrapper.launches += 1
            if V:
                wrapper.vol_launches += 1

        out = walk_launches(B, pixels, spp, launch, dev)
    return out[0], out[1], out[2], counters[0], counters[1], counters[2:]


def bdpt_megakernel(scene: SceneTensors, o: Vec3, d: Vec3, ray_ids, key,
                    depth: int, uniforms=None, mis: bool = False):
    """Whole BDPT sample from given rays.  ray_ids [B] int (negative =
    inactive lane); key: the base render key (streams 2/3/4 fold inside);
    uniforms: optional [n_uniform_slots(depth, V), B] f32 injected draws, V
    the scene's volumes;
    ``mis``: power-heuristic weighted strategies (integrator bdpt-mis).

    Returns (rad_x, rad_y, rad_z [B] f32, rays_traced, shadow_rays int64,
    extra int64[4] = (node_visits, aabb_hits, tri_tests, tri_hits))."""
    if _device_of(ray_ids).type == "cpu":
        return bdpt_megakernel_plain(scene, o, d, ray_ids, key, depth,
                                     uniforms, mis)
    return _launch(bdpt_megakernel, scene, [o.x, o.y, o.z, d.x, d.y, d.z], ray_ids,
                   rng.subkeys_bdpt(key, depth, scene.num_volumes), depth, mis, pixels=False,
                   ubuf=uniforms)


bdpt_megakernel.launches = bdpt_megakernel.vol_launches = 0


def bdpt_megakernel_pixels(scene: SceneTensors, i, j, pix_ids, cam13, key,
                           depth: int, sqrt_spp: int, mis: bool = False):
    """Fully fused BDPT: in-kernel ray generation and every stratum of each
    pixel.  i, j: [B] pixel coords; pix_ids [B]: pixel ids, whose samples
    are pix*spp + s (negative = inactive); cam13 from camera_table(); key:
    the base render key.  Returns the outputs of ``bdpt_megakernel`` with
    the radiance summed over strata."""
    if _device_of(pix_ids).type == "cpu":
        return bdpt_megakernel_pixels_plain(scene, i, j, pix_ids, cam13, key,
                                            depth, sqrt_spp, mis)
    return _launch(bdpt_megakernel_pixels, scene, [i, j], pix_ids,
                   rng.subkeys_bdpt_raygen(key, depth, scene.num_volumes), depth, mis,
                   pixels=True,
                   cam=cam13, sqrt_spp=sqrt_spp)


bdpt_megakernel_pixels.launches = bdpt_megakernel_pixels.vol_launches = 0
