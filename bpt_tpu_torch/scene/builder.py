"""Programmatic scene construction -> SceneTensors.

Counterpart of ``bpt_tpu.scene.builder`` (the reference's
triangle_collection helpers, src/objects/primatives/triangle.h:135-309):
triangles accumulate host-side in float64, transforms are baked at add
time, and ``build()`` flattens everything into tensors once, in the same
BVH leaf order as ``bpt_tpu`` so triangle ids and sums match it exactly,
with the BVH node arrays and the clustered hit kernels' subtree splits
(``cluster_splits``, ``super_splits``) beside them, the per-vertex UVs
and texture table of textured materials, and the constant-density volumes'
boundary soup, out of the surface arrays and the BVH.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bpt_tpu_torch.ops.clusters import CLUSTER_TRIS, MAX_CLUSTERS, SUPER
from bpt_tpu_torch.scene import bvh as bvh_mod
from bpt_tpu_torch.scene.obj import parse_obj
from bpt_tpu_torch.scene.textures import TextureSpec, build_texture_table
from bpt_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
    TEX_NOISE,
    MaterialTable,
    SceneTensors,
    scene_device,
)

PI = math.pi


@dataclass(frozen=True)
class MaterialSpec:
    """Host-side material description (one reference material subclass each,
    src/materials/material.h:42-172)."""

    mtype: int
    albedo: tuple = (0.0, 0.0, 0.0)  # lambertian/metal/isotropic albedo; light emission
    fuzz: float = 0.0
    ior: float = 1.5
    texture: Optional[TextureSpec] = None

    @staticmethod
    def lambertian(albedo=(0.0, 0.0, 0.0), texture=None):
        return MaterialSpec(MAT_LAMBERTIAN, tuple(albedo), texture=texture)

    @staticmethod
    def metal(albedo, fuzz=0.0):
        # fuzz clamp (material.h:71)
        return MaterialSpec(MAT_METAL, tuple(albedo), fuzz=min(float(fuzz), 1.0))

    @staticmethod
    def dielectric(ior):
        return MaterialSpec(MAT_DIELECTRIC, ior=float(ior))

    @staticmethod
    def diffuse_light(emission=(0.0, 0.0, 0.0), texture=None):
        return MaterialSpec(MAT_LIGHT, tuple(emission), texture=texture)

    @staticmethod
    def isotropic(albedo=(0.0, 0.0, 0.0), texture=None):
        return MaterialSpec(MAT_ISOTROPIC, tuple(albedo), texture=texture)


def rotate_y_point(p, sin_t, cos_t):
    """src/objects/primatives/triangle.h:243-249."""
    return (
        cos_t * p[0] + sin_t * p[2],
        p[1],
        -sin_t * p[0] + cos_t * p[2],
    )


def _bake_xform(p, rotate_y_degrees, translate):
    """Bake rotate_y then translate (src/objects/hittable.h:46-120) into a
    vertex, as add_box_triangles does (triangle.h:243-249 + offset)."""
    p = np.asarray(p, np.float64)
    if rotate_y_degrees != 0.0:
        rad = rotate_y_degrees * PI / 180.0
        p = np.array(rotate_y_point(p, math.sin(rad), math.cos(rad)))
    t = np.asarray(translate, np.float64)
    if t.any():
        p = p + t
    return p


class SceneBuilder:
    def __init__(self):
        self._tris: list[tuple] = []  # (v0, v1, v2, mat_index, uvs)
        self._materials: list[MaterialSpec] = []
        self._mat_index: dict[int, int] = {}  # id(spec) -> index
        self._volumes: list[tuple] = []  # (density, phase material index)
        self._vol_tris: list[tuple] = []  # (v0, v1, v2, volume id)
        self.background = (0.0, 0.0, 0.0)

    # ------------------------------------------------------------ materials

    def material(self, spec: MaterialSpec) -> int:
        key = id(spec)
        if key not in self._mat_index:
            self._mat_index[key] = len(self._materials)
            self._materials.append(spec)
        return self._mat_index[key]

    # ------------------------------------------------------------ geometry

    def add_triangle(self, v0, v1, v2, mat: MaterialSpec, uvs=None,
                     rotate_y_degrees=0.0, translate=(0, 0, 0)):
        """uvs: optional ((u0, v0), (u1, v1), (u2, v2)) texture coordinates
        a vertex; the default ((0, 0), (1, 0), (0, 1)) makes the
        interpolated hit (u, v) the barycentric (u, v), the reference's
        hit_record.  rotate_y_degrees / translate bake the reference's
        instancing wrappers (src/objects/hittable.h:46-120) at add time;
        the UVs ride the rotated object unchanged."""
        if rotate_y_degrees != 0.0 or any(translate):
            v0 = _bake_xform(v0, rotate_y_degrees, translate)
            v1 = _bake_xform(v1, rotate_y_degrees, translate)
            v2 = _bake_xform(v2, rotate_y_degrees, translate)
        mid = self.material(mat)
        self._tris.append((tuple(v0), tuple(v1), tuple(v2), mid, uvs))

    def add_quad(self, q, u, v, mat: MaterialSpec,
                 rotate_y_degrees=0.0, translate=(0, 0, 0)):
        """add_quad_triangles (triangle.h:232-241): (q, q+u, q+v) and
        (q+u, q+u+v, q+v)."""
        q = np.asarray(q, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        xf = dict(rotate_y_degrees=rotate_y_degrees, translate=translate)
        self.add_triangle(q, q + u, q + v, mat, **xf)
        self.add_triangle(q + u, q + u + v, q + v, mat, **xf)

    def add_box(self, a, b, mat: MaterialSpec, rotate_y_degrees=0.0,
                translate=(0, 0, 0)):
        """add_box_triangles (triangle.h:251-309): 12 tris with baked
        Y-rotation + translation."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        v = {}
        for ix in (0, 1):
            for iy in (0, 1):
                for iz in (0, 1):
                    v[(ix, iy, iz)] = np.array([
                        mx[0] if ix else mn[0],
                        mx[1] if iy else mn[1],
                        mx[2] if iz else mn[2],
                    ])
        faces = [
            (v[0, 0, 1], v[1, 0, 1], v[1, 1, 1]), (v[0, 0, 1], v[1, 1, 1], v[0, 1, 1]),  # +Z
            (v[0, 0, 0], v[0, 1, 0], v[1, 1, 0]), (v[0, 0, 0], v[1, 1, 0], v[1, 0, 0]),  # -Z
            (v[0, 0, 0], v[0, 0, 1], v[0, 1, 1]), (v[0, 0, 0], v[0, 1, 1], v[0, 1, 0]),  # -X
            (v[1, 0, 1], v[1, 0, 0], v[1, 1, 0]), (v[1, 0, 1], v[1, 1, 0], v[1, 1, 1]),  # +X
            (v[0, 1, 1], v[1, 1, 1], v[1, 1, 0]), (v[0, 1, 1], v[1, 1, 0], v[0, 1, 0]),  # +Y
            (v[0, 0, 0], v[1, 0, 0], v[1, 0, 1]), (v[0, 0, 0], v[1, 0, 1], v[0, 0, 1]),  # -Y
        ]
        rad = rotate_y_degrees * PI / 180.0
        s, c = math.sin(rad), math.cos(rad)
        t = np.asarray(translate, np.float64)
        for p0, p1, p2 in faces:
            if rotate_y_degrees != 0.0:
                p0 = np.array(rotate_y_point(p0, s, c))
                p1 = np.array(rotate_y_point(p1, s, c))
                p2 = np.array(rotate_y_point(p2, s, c))
            self.add_triangle(p0 + t, p1 + t, p2 + t, mat)

    def add_uv_sphere(self, center, radius, mat: MaterialSpec, lat_steps=16,
                      lon_steps=32, rotate_y_degrees=0.0, translate=(0, 0, 0)):
        """add_uv_sphere (scene_loader.h:212-242): 16x32 tessellation, pole
        caps emit a single triangle per quad, with bpt_tpu's spherical UVs
        of the unrotated parametrisation (the texture turns with the
        sphere, as under the reference's ray-space rotate_y wrapper,
        hittable.h:76-120)."""
        center = np.asarray(center, np.float64)
        xf = dict(rotate_y_degrees=rotate_y_degrees, translate=translate)

        def pt(theta, phi):
            st = math.sin(theta)
            return center + radius * np.array(
                [st * math.cos(phi), math.cos(theta), st * math.sin(phi)])

        def uv(theta, phi):
            # bpt_tpu's spherical UVs: the reference's tessellation has none
            return (phi / (2.0 * PI), 1.0 - theta / PI)

        for lat in range(lat_steps):
            th0 = PI * lat / lat_steps
            th1 = PI * (lat + 1) / lat_steps
            for lon in range(lon_steps):
                ph0 = 2.0 * PI * lon / lon_steps
                ph1 = 2.0 * PI * (lon + 1) / lon_steps
                p00, p01 = pt(th0, ph0), pt(th0, ph1)
                p10, p11 = pt(th1, ph0), pt(th1, ph1)
                if lat > 0:
                    self.add_triangle(p00, p10, p11, mat,
                                      uvs=(uv(th0, ph0), uv(th1, ph0), uv(th1, ph1)), **xf)
                if lat < lat_steps - 1:
                    self.add_triangle(p00, p11, p01, mat,
                                      uvs=(uv(th0, ph0), uv(th1, ph1), uv(th0, ph1)), **xf)

    def add_obj(self, path, mat: MaterialSpec, rotate_y_degrees=0.0,
                translate=(0, 0, 0)):
        for v0, v1, v2 in parse_obj(path):
            self.add_triangle(v0, v1, v2, mat, rotate_y_degrees=rotate_y_degrees,
                              translate=translate)

    # ------------------------------------------------------------- volumes

    def add_volume(self, boundary_tris, density, albedo=(1.0, 1.0, 1.0),
                   texture=None) -> int:
        """constant_medium (src/materials/volumes/constant_medium.h:8-61): a
        homogeneous volume with an isotropic phase function, whose boundary
        triangles (an iterable of (v0, v1, v2)) stay out of the surface
        arrays: rays pass through them and scatter at an exponential
        free-flight distance.  Returns the volume's id."""
        phase = MaterialSpec.isotropic(tuple(albedo), texture=texture)
        vid = len(self._volumes)
        self._volumes.append((float(density), self.material(phase)))
        for v0, v1, v2 in boundary_tris:
            self._vol_tris.append((tuple(v0), tuple(v1), tuple(v2), vid))
        return vid

    def add_volume_box(self, a, b, density, albedo=(1.0, 1.0, 1.0),
                       rotate_y_degrees=0.0, translate=(0, 0, 0),
                       texture=None) -> int:
        tmp = SceneBuilder()
        tmp.add_box(a, b, MaterialSpec.lambertian(), rotate_y_degrees, translate)
        return self.add_volume([t[:3] for t in tmp._tris], density, albedo,
                               texture=texture)

    def add_volume_sphere(self, center, radius, density, albedo=(1.0, 1.0, 1.0),
                          lat_steps=16, lon_steps=32, texture=None) -> int:
        tmp = SceneBuilder()
        tmp.add_uv_sphere(center, radius, MaterialSpec.lambertian(), lat_steps, lon_steps)
        return self.add_volume([t[:3] for t in tmp._tris], density, albedo,
                               texture=texture)

    # -------------------------------------------------------------- build

    @property
    def num_tris(self) -> int:
        return len(self._tris)

    def build(self, dtype=torch.float32, device="cuda", background=None,
              perlin_seed: int = 0) -> SceneTensors:
        device = scene_device(device)
        if not self._tris:
            raise ValueError("empty scene")
        if background is None:
            background = self.background

        verts = np.array([(t[0], t[1], t[2]) for t in self._tris], np.float64)
        mat_id = np.array([t[3] for t in self._tris], np.int64)
        T = verts.shape[0]
        tri_uv = np.tile(np.array([0.0, 0.0, 1.0, 0.0, 0.0, 1.0]), (T, 1))
        for k, t in enumerate(self._tris):
            if t[4] is not None:
                tri_uv[k] = np.asarray(t[4], np.float64).reshape(6)

        # triangle precompute (triangle.h:21-38)
        v0 = verts[:, 0]
        e1 = verts[:, 1] - v0
        e2 = verts[:, 2] - v0
        n = np.cross(e1, e2)
        nlen = np.linalg.norm(n, axis=-1)
        area = 0.5 * nlen
        safe = np.where(nlen > 0, nlen, 1.0)
        normal = n / safe[:, None]

        # BVH and its leaf order (bpt_tpu/scene/builder.py:293-300)
        tree = bvh_mod.build_bvh(verts.min(axis=1), verts.max(axis=1))
        order = tree["order"]
        v0, e1, e2 = v0[order], e1[order], e2[order]
        normal, area, mat_id = normal[order], area[order], mat_id[order]
        tri_uv = tri_uv[order]

        mats = self._materials
        mtypes = np.array([m.mtype for m in mats], np.int64)

        def ten(a, dt=dtype):
            return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

        # textured materials index the texture table (bpt_tpu/scene/builder.py:304-320)
        tex_specs, tex_ids = [], []
        for m in mats:
            tex_ids.append(len(tex_specs) if m.texture is not None else -1)
            if m.texture is not None:
                tex_specs.append(m.texture)
        materials = MaterialTable(
            mtype=ten(mtypes, torch.int64),
            albedo=ten([m.albedo for m in mats]),
            fuzz=ten([m.fuzz for m in mats]),
            ior=ten([m.ior for m in mats]),
            tex_id=ten(tex_ids, torch.int64),
        )
        textures = build_texture_table(tex_specs, dtype=dtype, device=device,
                                       perlin_seed=perlin_seed)

        # lights: emissive triangles (scene_loader.h:190-202); empty ->
        # whole world (main.cpp:67)
        light_idx = np.nonzero(mtypes[mat_id] == MAT_LIGHT)[0]
        lights_are_world = light_idx.size == 0
        if lights_are_world:
            light_idx = np.arange(T)
        # area CDF built as bpt_tpu builds it (a numpy cumsum in f64, then
        # a cast to the scene dtype: bpt_tpu/scene/builder.py:335-338)
        light_cdf = np.cumsum(area[light_idx])
        total_area = float(light_cdf[-1])
        use_bvh = T > 256  # bpt_tpu's brute-force threshold

        # the clustered hit kernels' subtree-aligned splits, with the
        # fill-merge (bpt_tpu/scene/builder.py:343-362); past MAX_CLUSTERS
        # none, and the kernels take the fixed-stride chop
        cluster_splits = super_splits = ()
        if use_bvh:
            cs = bvh_mod.subtree_splits(tree["bvh_skip"], tree["bvh_count"], CLUSTER_TRIS)
            if len(cs) - 1 <= MAX_CLUSTERS:
                ss = bvh_mod.subtree_splits(tree["bvh_skip"], tree["bvh_count"],
                                            CLUSTER_TRIS * SUPER)
                super_splits = bvh_mod.merge_splits(ss, (0, T), CLUSTER_TRIS * SUPER)
                cluster_splits = bvh_mod.merge_splits(cs, super_splits, CLUSTER_TRIS)

        # volumes (bpt_tpu/scene/builder.py:364-375): one zero row without
        if self._vol_tris:
            vverts = np.array([t[:3] for t in self._vol_tris], np.float64)
            vv0 = vverts[:, 0]
            ve1 = vverts[:, 1] - vv0
            ve2 = vverts[:, 2] - vv0
            vol_tri_vol = np.array([t[3] for t in self._vol_tris], np.int32)
        else:
            vv0 = ve1 = ve2 = np.zeros((1, 3))
            vol_tri_vol = np.zeros((1,), np.int32)
        vol_density = np.array([v[0] for v in self._volumes] or [1.0], np.float64)
        vol_mat = np.array([v[1] for v in self._volumes] or [0], np.int32)

        return SceneTensors(
            v0=ten(v0), e1=ten(e1), e2=ten(e2),
            normal=ten(normal), area=ten(area),
            mat_id=ten(mat_id, torch.int64),
            tri_uv=ten(tri_uv),
            light_v0=ten(v0[light_idx]),
            light_e1=ten(e1[light_idx]),
            light_e2=ten(e2[light_idx]),
            light_normal=ten(normal[light_idx]),
            light_area=ten(area[light_idx]),
            light_cdf=ten(light_cdf),
            light_total_area=ten(total_area),
            light_mat=ten(mat_id[light_idx], torch.int64),
            bvh_min=ten(tree["bvh_min"]),
            bvh_max=ten(tree["bvh_max"]),
            bvh_skip=ten(tree["bvh_skip"], torch.int32),
            bvh_first=ten(tree["bvh_first"], torch.int32),
            bvh_count=ten(tree["bvh_count"], torch.int32),
            materials=materials,
            textures=textures,
            background=ten(np.asarray(background, np.float64)),
            vol_v0=ten(vv0), vol_e1=ten(ve1), vol_e2=ten(ve2),
            vol_tri_vol=ten(vol_tri_vol, torch.int32),
            vol_neg_inv_density=ten(-1.0 / vol_density),
            vol_mat=ten(vol_mat, torch.int32),
            num_tris=T,
            num_lights=int(light_idx.size),
            num_volumes=len(self._volumes),
            use_bvh=use_bvh,
            has_textures=bool(tex_specs),
            has_noise=any(s.kind == TEX_NOISE for s in tex_specs),
            cluster_splits=cluster_splits,
            super_splits=super_splits,
            has_delta_mats=bool(np.any((mtypes == MAT_METAL)
                                       | (mtypes == MAT_DIELECTRIC))),
            has_iso_mats=bool(np.any(mtypes == MAT_ISOTROPIC)),
            lights_are_world=lights_are_world,
        )
