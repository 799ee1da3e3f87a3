"""Scene tensors: the flattened triangle scene the render loop reads.

Counterpart of ``bpt_tpu.scene.types.SceneArrays`` holding the fields the
PT and BDPT megakernels' tables (``_pack_tables``, ``_pack_tables_bdpt``),
the BVH traversals (``ops.soa.bvh_closest`` / ``bvh_any``, ``csrc/pt_wave.cu``), the
clustered hit kernels (``ops/clusters.py``, ``ops/plucker.py``) and the
estimators read, plus the static meta: the triangles' per-vertex UVs and the
texture table (``scene/textures.py``) among them, and the constant-density
volumes: their boundary triangle soup, kept out of the surface arrays and
the BVH, with each volume's density and phase material.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from dataclasses import dataclass

import numpy as np
import torch

# Material type ids (reference classes, src/materials/material.h:42-172)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture kinds (reference classes, src/materials/textures/texture.h:14-87)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3


@dataclass(frozen=True)
class TextureTable:
    """Texture parameter SoA (src/materials/textures/texture.h:7-87).

    ``kind`` selects solid / checker / image / noise; unused parameters are
    zero.  Image texels live in a padded atlas ``images[I, Hmax, Wmax, 3]``
    (byte values as floats, 0..255) with each image's true size; the perlin
    lattice tables (texture.h:76-87, perlin.h) are baked at build."""

    kind: torch.Tensor  # [K] int64
    color0: torch.Tensor  # [K,3] solid colour / checker even
    color1: torch.Tensor  # [K,3] checker odd
    scale: torch.Tensor  # [K] checker scale (world units) or noise scale
    img_id: torch.Tensor  # [K] int64 index into images (or 0)
    images: torch.Tensor  # [I, Hmax, Wmax, 3] float, 0..255
    img_h: torch.Tensor  # [I] int64
    img_w: torch.Tensor  # [I] int64
    perlin_randvec: torch.Tensor  # [256, 3]
    perlin_perm: torch.Tensor  # [3, 256] int64 (x, y, z permutations)


@dataclass(frozen=True)
class MaterialTable:
    """Branchless material parameter table; ``albedo`` doubles as emission
    for MAT_LIGHT.  ``tex_id`` < 0 means the ``albedo`` column, >= 0 indexes
    the TextureTable."""

    mtype: torch.Tensor  # [M] int64
    albedo: torch.Tensor  # [M,3]
    fuzz: torch.Tensor  # [M]  (metal)
    ior: torch.Tensor  # [M]  (dielectric)
    tex_id: torch.Tensor  # [M] int64


@dataclass(frozen=True)
class SceneTensors:
    """Triangle SoA in BVH leaf order + light tables + static meta."""

    # triangle SoA (src/objects/primatives/triangle.h:19-39)
    v0: torch.Tensor  # [T,3]
    e1: torch.Tensor  # [T,3]
    e2: torch.Tensor  # [T,3]
    normal: torch.Tensor  # [T,3] geometric unit normal
    area: torch.Tensor  # [T]
    mat_id: torch.Tensor  # [T] int64
    # per-vertex texture UVs (u0, v0, u1, v1, u2, v2); the default
    # (0,0),(1,0),(0,1) leaves the hit's barycentric (u, v) unchanged
    tri_uv: torch.Tensor  # [T,6]

    # light triangles (emissive tris, or the whole world when none)
    light_v0: torch.Tensor  # [L,3]
    light_e1: torch.Tensor  # [L,3]
    light_e2: torch.Tensor  # [L,3]
    light_normal: torch.Tensor  # [L,3]
    light_area: torch.Tensor  # [L]
    # sample_surface's area CDF (triangle.h:199-224)
    light_cdf: torch.Tensor  # [L] inclusive prefix sum of light areas
    light_total_area: torch.Tensor  # [] scalar
    light_mat: torch.Tensor  # [L] int64

    # threaded-DFS BVH, preorder with skip links (scene/bvh.py)
    bvh_min: torch.Tensor  # [N,3]
    bvh_max: torch.Tensor  # [N,3]
    bvh_skip: torch.Tensor  # [N] int32: next node when the box is missed
    bvh_first: torch.Tensor  # [N] int32: first triangle of a leaf
    bvh_count: torch.Tensor  # [N] int32: leaf triangle count (0 = internal)

    materials: MaterialTable
    textures: TextureTable
    background: torch.Tensor  # [3]

    # constant-density volumes (constant_medium, src/materials/volumes/
    # constant_medium.h; bpt_tpu/scene/types.py:133-146): the boundary
    # triangle soup, grouped by owner, out of the surface arrays (rays pass
    # through it and scatter at an exponential free-flight distance).  A
    # scene without volumes holds one zero row of each.
    vol_v0: torch.Tensor  # [VT,3]
    vol_e1: torch.Tensor  # [VT,3]
    vol_e2: torch.Tensor  # [VT,3]
    vol_tri_vol: torch.Tensor  # [VT] int32: the owning volume
    vol_neg_inv_density: torch.Tensor  # [V] = -1/density
    vol_mat: torch.Tensor  # [V] int32: the isotropic phase material

    # static metadata (bpt_tpu/scene/types.py:144-164)
    num_tris: int = 0
    num_lights: int = 0
    num_volumes: int = 0
    use_bvh: bool = True
    has_textures: bool = False
    has_noise: bool = False
    # BVH-subtree-aligned split points of the clustered hit kernels
    # (ops/clusters.py; bpt_tpu/scene/types.py:149-156): cluster k covers
    # the triangles [cluster_splits[k], cluster_splits[k + 1]) and is a
    # subtree of <= 32; superclusters likewise of <= 512.  () -> the
    # fixed-stride chop.
    cluster_splits: tuple = ()
    super_splits: tuple = ()
    has_delta_mats: bool = True
    has_iso_mats: bool = True
    lights_are_world: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return self.v0.dtype

    @property
    def device(self) -> torch.device:
        return self.v0.device


_INT_FIELDS = {"mat_id": torch.int64, "light_mat": torch.int64,
               "materials.mtype": torch.int64, "materials.tex_id": torch.int64,
               "bvh_skip": torch.int32, "bvh_first": torch.int32,
               "bvh_count": torch.int32, "vol_tri_vol": torch.int32,
               "vol_mat": torch.int32, "textures.kind": torch.int64,
               "textures.img_id": torch.int64, "textures.img_h": torch.int64,
               "textures.img_w": torch.int64, "textures.perlin_perm": torch.int64}
_TABLES = {"materials": MaterialTable, "textures": TextureTable}
_META_TYPES = {
    f.name: {"int": int, "bool": bool, "tuple": tuple}[f.type]
    for f in dataclasses.fields(SceneTensors) if f.type in ("int", "bool", "tuple")
}
_META_FIELDS = list(_META_TYPES)
_TENSOR_FIELDS = [
    f.name for f in dataclasses.fields(SceneTensors)
    if f.name not in _META_FIELDS and f.name not in _TABLES
] + [f"{t}.{f.name}" for t, cls in _TABLES.items() for f in dataclasses.fields(cls)]


def per_scene(fn):
    """``fn(scene)``, computed once a scene and kept while the scene lives
    (in ``<wrapper>.cache``, by ``id(scene)``): the kernels' tables, which
    every hit call of a wave reads."""
    cache = {}

    @functools.wraps(fn)
    def tables(scene):
        got = cache.get(id(scene))
        if got is None:
            got = cache[id(scene)] = fn(scene)
            weakref.finalize(scene, cache.pop, id(scene), None)
        return got

    tables.cache = cache
    return tables


def scene_device(device) -> torch.device:
    """The device a scene factory puts its tensors on: ``"cuda"`` unless
    the caller asks for the CPU.  Raises where there is no card rather
    than falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to build "
                           "the scene for the kernels' plain PyTorch versions")
    return dev


def scene_from_numpy(d: dict, meta: dict, device="cuda",
                     dtype=torch.float32) -> SceneTensors:
    """Build SceneTensors from host arrays: the state carry-over from any
    producer of the same fields (e.g. ``np.asarray`` of every field of a
    ``bpt_tpu`` SceneArrays, the material and texture tables keyed
    ``"materials.<field>"`` and ``"textures.<field>"``).

    Keys and meta entries this port does not carry are ignored; a missing
    key raises KeyError."""

    device = scene_device(device)

    def conv(name):
        t = torch.from_numpy(np.array(d[name]))  # a copy: inputs may be read-only
        return t.to(device=device, dtype=_INT_FIELDS.get(name, dtype))

    tables = {t: cls(**{f.name: conv(f"{t}.{f.name}") for f in dataclasses.fields(cls)})
              for t, cls in _TABLES.items()}
    tensors = {n: conv(n) for n in _TENSOR_FIELDS if "." not in n}
    static = {n: t(meta[n]) for n, t in _META_TYPES.items() if n in meta}
    return SceneTensors(**tables, **tensors, **static)


def scene_to_numpy(scene: SceneTensors) -> tuple[dict, dict]:
    """Inverse of scene_from_numpy: (arrays, meta)."""
    arrays = {}
    for n in _TENSOR_FIELDS:
        obj = scene
        for part in n.split("."):
            obj = getattr(obj, part)
        arrays[n] = obj.detach().cpu().numpy()
    meta = {n: getattr(scene, n) for n in _META_FIELDS}
    return arrays, meta


@dataclass(frozen=True)
class CameraConfig:
    """Host-side camera config — mirror of the reference's public camera
    fields (src/camera.h:26-41)."""

    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 50
    max_depth: int = 10
    background: tuple = (0.0, 0.0, 0.0)
    vfov: float = 90.0
    lookfrom: tuple = (0.0, 0.0, 0.0)
    lookat: tuple = (0.0, 0.0, -1.0)
    vup: tuple = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    file_name: str = "image.png"
    integrator: str = "bdpt"  # reference de-facto default (camera.h:245-253)
    # BDPT's emulation of the reference binary's shadow-endpoint artifact
    # (models.bdpt.connect_paths; bpt_tpu/scene/types.py:217)
    ref_vis: bool = False

    @property
    def image_height(self) -> int:
        # src/camera.h:161-162
        return max(int(self.image_width / self.aspect_ratio), 1)

    @property
    def sqrt_spp(self) -> int:
        # src/camera.h:164 — effective spp is floor(sqrt(spp))^2
        return max(1, int(np.sqrt(self.samples_per_pixel)))

    @property
    def effective_spp(self) -> int:
        return self.sqrt_spp * self.sqrt_spp
