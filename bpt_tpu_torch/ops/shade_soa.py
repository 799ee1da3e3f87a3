"""SoA shading: branchless materials, sampling and light machinery on
component tensors — counterpart of ``bpt_tpu.ops.shade_soa``.  A textured
material's albedo is its texel at the hit's (u, v, p)
(``scene/textures.py::texture_value``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from bpt_tpu_torch.core import vec3 as v3
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.core.vecmath import PI
from bpt_tpu_torch.ops.intersect import MT_EPSILON, T_MIN
from bpt_tpu_torch.ops.soa import _mt_all
from bpt_tpu_torch.scene.textures import texture_value
from bpt_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
    SceneTensors,
)

SPHERE_PDF = 1.0 / (4.0 * PI)


# ---------------------------------------------------------------- sampling


def cosine_direction_world(normal: Vec3, u1, u2) -> Vec3:
    """random_cosine_direction (vec3.h:149-159) through the reference ONB."""
    phi = 2.0 * PI * u1
    sq = torch.sqrt(u2)
    lx = torch.cos(phi) * sq
    ly = torch.sin(phi) * sq
    lz = torch.sqrt(1.0 - u2)
    u, v, w = v3.onb_from_w(normal)
    return v3.onb_transform(u, v, w, lx, ly, lz)


def uniform_sphere_direction(u1, u2) -> Vec3:
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def triangle_barycentric(u1, u2):
    flip = (u1 + u2) > 1.0
    return torch.where(flip, 1.0 - u1, u1), torch.where(flip, 1.0 - u2, u2)


def schlick(cosine, ri):
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


# --------------------------------------------------------------- materials


def albedo_value(scene: SceneTensors, mat, u, v, p: Vec3) -> Vec3:
    """The material's albedo, or its texel where it has a texture."""
    base = v3.gather(scene.materials.albedo, mat)
    if not scene.has_textures:
        return base
    tid = scene.materials.tex_id[mat]
    tex = texture_value(scene.textures, torch.clamp_min(tid, 0), u, v, v3.to_array(p),
                        with_noise=scene.has_noise)
    return v3.where(tid >= 0, v3.from_array(tex), base)


def emitted(scene: SceneTensors, mat, front_face, u, v, p: Vec3) -> Vec3:
    mtype = scene.materials.mtype[mat]
    emit = albedo_value(scene, mat, u, v, p)
    mask = (mtype == MAT_LIGHT) & front_face
    zero = torch.zeros_like(emit.x)
    return v3.where(mask, emit, Vec3(zero, zero, zero))


def is_delta(mtype):
    return (mtype == MAT_METAL) | (mtype == MAT_DIELECTRIC)


def attenuation(scene: SceneTensors, mat, mtype, u, v, p: Vec3) -> Vec3:
    alb = albedo_value(scene, mat, u, v, p)
    one = torch.ones_like(alb.x)
    return v3.where(mtype == MAT_DIELECTRIC, Vec3(one, one, one), alb)


def delta_scatter_dir(
    scene: SceneTensors, mat, mtype, d_in: Vec3, normal: Vec3, front_face,
    u_choice, u_s1, u_s2,
) -> Vec3:
    # metal (material.h:73-83)
    fuzz = scene.materials.fuzz[mat]
    refl = v3.normalize_safe(v3.reflect(d_in, normal))
    sph = uniform_sphere_direction(u_s1, u_s2)
    metal_dir = Vec3(
        refl.x + fuzz * sph.x, refl.y + fuzz * sph.y, refl.z + fuzz * sph.z
    )
    # dielectric (material.h:96-116)
    ior = scene.materials.ior[mat]
    ri = torch.where(front_face, 1.0 / ior, ior)
    ud = v3.normalize_safe(d_in)
    cos_t = torch.clamp_max(v3.dot(-ud, normal), 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    reflect_choice = (ri * sin_t > 1.0) | (schlick(cos_t, ri) > u_choice)
    diel = v3.where(reflect_choice, v3.reflect(ud, normal),
                    v3.refract(ud, normal, ri))
    return v3.where(mtype == MAT_METAL, metal_dir, diel)


def sample_bsdf_dir(mtype, normal: Vec3, u1, u2) -> Vec3:
    cos_dir = cosine_direction_world(normal, u1, u2)
    sph = uniform_sphere_direction(u1, u2)
    return v3.where(mtype == MAT_ISOTROPIC, sph, cos_dir)


def bsdf_pdf_value(mtype, normal: Vec3, direction: Vec3):
    cos_t = v3.dot(v3.normalize_safe(direction), normal)
    cos_pdf = torch.clamp_min(cos_t / PI, 0.0)
    return torch.where(mtype == MAT_ISOTROPIC, SPHERE_PDF, cos_pdf)


def scattering_pdf(mtype, normal: Vec3, direction: Vec3):
    cos_t = v3.dot(normal, v3.normalize_safe(direction))
    lam = torch.where(cos_t < 0.0, 0.0, cos_t / PI)
    out = torch.where(mtype == MAT_LAMBERTIAN, lam, 0.0)
    return torch.where(mtype == MAT_ISOTROPIC, SPHERE_PDF, out)


def evaluate_bsdf(scene: SceneTensors, mat, mtype, u, v, p: Vec3) -> Vec3:
    """The reference's direction-free BSDF value (material.h:35-37, 60-63):
    albedo/pi for lambertian, albedo/(4 pi) for isotropic, 0 otherwise."""
    alb = albedo_value(scene, mat, u, v, p)
    zero = torch.zeros_like(alb.x)
    out = v3.where(mtype == MAT_LAMBERTIAN, alb * (1.0 / PI), Vec3(zero, zero, zero))
    return v3.where(mtype == MAT_ISOTROPIC, alb * (1.0 / (4.0 * PI)), out)


# ------------------------------------------------------------------ lights


def light_pdf_value(scene: SceneTensors, origin: Vec3, direction: Vec3):
    """triangle_collection::pdf_value (triangle.h:170-181): uniform-weight
    mean of per-light-triangle solid-angle pdfs — one [L,B] broadcast."""
    L = scene.num_lights
    det, t, u, vv = _mt_all(scene.light_v0, scene.light_e1, scene.light_e2,
                            origin, direction)  # [L,B]
    valid = (
        (torch.abs(det) >= MT_EPSILON)
        & (u >= 0.0) & (u <= 1.0) & (vv >= 0.0) & (u + vv <= 1.0)
        & (t >= T_MIN)
    )
    d_len2 = v3.length_squared(direction)  # [B]
    d_len = torch.sqrt(d_len2)
    dist2 = t * t * d_len2[None]
    ln = scene.light_normal
    cosine = torch.abs(
        direction.x[None] * ln[:, 0:1]
        + direction.y[None] * ln[:, 1:2]
        + direction.z[None] * ln[:, 2:3]
    ) / d_len[None]
    area = scene.light_area[:, None]
    ok = valid & (area > 0.0) & (cosine > 0.0)
    pdf = torch.where(ok, dist2 / torch.where(ok, cosine * area, 1.0), 0.0)
    return torch.sum(pdf, dim=0) / L


def sample_light_dir(scene: SceneTensors, origin: Vec3, u_pick, u1, u2) -> Vec3:
    """triangle_collection::random (triangle.h:183-189): unnormalized
    p - origin from a uniformly picked light triangle."""
    L = scene.num_lights
    idx = torch.clamp((u_pick * L).to(torch.int64), 0, L - 1)
    u, v = triangle_barycentric(u1, u2)
    lv0 = v3.gather(scene.light_v0, idx)
    le1 = v3.gather(scene.light_e1, idx)
    le2 = v3.gather(scene.light_e2, idx)
    return Vec3(
        lv0.x + u * le1.x + v * le2.x - origin.x,
        lv0.y + u * le1.y + v * le2.y - origin.y,
        lv0.z + u * le1.z + v * le2.z - origin.z,
    )


class SurfaceSampleSoA(NamedTuple):
    position: Vec3
    normal: Vec3
    mat: torch.Tensor
    pdf: torch.Tensor
    valid: torch.Tensor


def sample_surface(scene: SceneTensors, u_pick, u1, u2) -> SurfaceSampleSoA:
    """Area-weighted CDF emitter sampling (triangle.h:199-224): the light
    whose inclusive area prefix first reaches ``u_pick * total``."""
    total = scene.light_total_area
    pick = u_pick * total
    idx = torch.searchsorted(scene.light_cdf, pick)  # side="left"
    idx = torch.clamp(idx, 0, scene.num_lights - 1)
    u, v = triangle_barycentric(u1, u2)
    lv0 = v3.gather(scene.light_v0, idx)
    le1 = v3.gather(scene.light_e1, idx)
    le2 = v3.gather(scene.light_e2, idx)
    p = Vec3(
        lv0.x + u * le1.x + v * le2.x,
        lv0.y + u * le1.y + v * le2.y,
        lv0.z + u * le1.z + v * le2.z,
    )
    inv_total = torch.where(total > 0.0, 1.0 / torch.clamp_min(total, 1e-30), 0.0)
    return SurfaceSampleSoA(
        position=p,
        normal=v3.gather(scene.light_normal, idx),
        mat=scene.light_mat[idx],
        pdf=torch.broadcast_to(inv_total, u_pick.shape),
        valid=torch.broadcast_to(total > 0.0, u_pick.shape),
    )
