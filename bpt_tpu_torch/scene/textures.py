"""Texture table construction (host) and batched texture evaluation.

Counterpart of ``bpt_tpu.scene.textures``: the reference classes
solid_color / checker_texture / image_texture / noise_texture
(src/materials/textures/texture.h:14-87) and the perlin lattice
(src/materials/textures/perlin.h).  Images are decoded on the host with
Pillow (the reference vendors stb_image) into a padded atlas; the lookup is
the reference's clamped, V-flipped, nearest-neighbour byte fetch
(texture.h:57-73).  Where Pillow is missing or a file does not decode, the
image is the reference's 1x1 magenta load-failure pixel.  The perlin tables
come from numpy's ``default_rng(seed)``, as ``bpt_tpu``'s do, so both
packages build them bit for bit.  ``texture_value`` runs as torch ops on
the table's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bpt_tpu_torch.scene.types import (
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TEX_SOLID,
    TextureTable,
)

_MAGENTA = np.array([255.0, 0.0, 255.0])  # load-failure pixel (rtw_stb_image.h:63-67)


@dataclass(frozen=True)
class TextureSpec:
    """Host-side texture description used by SceneBuilder and the loader."""

    kind: int = TEX_SOLID
    color0: tuple = (0.0, 0.0, 0.0)
    color1: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0
    image_path: Optional[str] = None

    @staticmethod
    def solid(color):
        return TextureSpec(kind=TEX_SOLID, color0=tuple(color))

    @staticmethod
    def checker(scale, even, odd):
        return TextureSpec(kind=TEX_CHECKER, color0=tuple(even), color1=tuple(odd),
                           scale=scale)

    @staticmethod
    def image(path):
        return TextureSpec(kind=TEX_IMAGE, image_path=str(path))

    @staticmethod
    def noise(scale):
        return TextureSpec(kind=TEX_NOISE, scale=scale)


def _resolve_image_path(path: str):
    """The reference loader's search order (rtw_stb_image.h:28-36):
    $RTW_IMAGES/<name> first, then the literal path (relative to the
    working directory), then images/<name>.  Returns the first candidate
    that exists, else None."""
    candidates = []
    env_dir = os.environ.get("RTW_IMAGES", "")
    if env_dir:
        candidates.append(os.path.join(env_dir, os.path.basename(path)))
    candidates.append(path)
    candidates.append(os.path.join("images", os.path.basename(path)))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def _load_image(path: str) -> np.ndarray:
    """Decode to [H, W, 3] float64 0..255; the 1x1 magenta pixel on any
    failure, a missing Pillow included (rtw_stb_image.h:44-67)."""
    try:
        from PIL import Image

        resolved = _resolve_image_path(str(path))
        if resolved is None:
            raise FileNotFoundError(path)
        with Image.open(resolved) as im:
            arr = np.asarray(im.convert("RGB"), dtype=np.float64)
        if arr.size == 0:
            raise ValueError("empty image")
        return arr
    except Exception:  # the reference's rule: any failure is magenta
        return _MAGENTA.reshape(1, 1, 3)


def _build_perlin(seed: int = 0):
    """The reference perlin construction (perlin.h:6-14, 75-92): 256 unit
    vectors from normalised cube samples and three permutations."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=(256, 3))
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    norms[norms == 0] = 1.0
    randvec = v / norms
    perms = np.stack([rng.permutation(256) for _ in range(3)])
    return randvec, perms


def build_texture_table(specs, dtype=torch.float32, device="cpu",
                        perlin_seed: int = 0) -> TextureTable:
    """Flatten TextureSpecs (possibly none) into a TextureTable on
    ``device``: floats in ``dtype``, indices int64."""
    if not specs:
        specs = [TextureSpec.solid((0.0, 0.0, 0.0))]

    images, img_ids = [], []
    for s in specs:
        if s.kind == TEX_IMAGE:
            img_ids.append(len(images))
            images.append(_load_image(s.image_path))
        else:
            img_ids.append(0)
    if not images:
        images = [np.zeros((1, 1, 3))]

    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    atlas = np.zeros((len(images), hmax, wmax, 3))
    for i, im in enumerate(images):
        atlas[i, : im.shape[0], : im.shape[1]] = im
    randvec, perms = _build_perlin(perlin_seed)

    def ten(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

    return TextureTable(
        kind=ten([s.kind for s in specs], torch.int64),
        color0=ten(np.array([s.color0 for s in specs], np.float64)),
        color1=ten(np.array([s.color1 for s in specs], np.float64)),
        scale=ten(np.array([s.scale for s in specs], np.float64)),
        img_id=ten(img_ids, torch.int64),
        images=ten(atlas),
        img_h=ten([im.shape[0] for im in images], torch.int64),
        img_w=ten([im.shape[1] for im in images], torch.int64),
        perlin_randvec=ten(randvec),
        perlin_perm=ten(perms, torch.int64),
    )


# ------------------------------------------------------------- evaluation


def _perlin_noise(tt: TextureTable, p):
    """perlin::noise (perlin.h:16-36): smoothstep trilinear interpolation
    of dotted lattice gradients.  p [..., 3] -> [...]."""
    pf = torch.floor(p)
    uvw = p - pf
    ijk = pf.to(torch.int64)
    uu = uvw * uvw * (3.0 - 2.0 * uvw)

    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                xi = (ijk[..., 0] + di) & 255
                yj = (ijk[..., 1] + dj) & 255
                zk = (ijk[..., 2] + dk) & 255
                h = tt.perlin_perm[0, xi] ^ tt.perlin_perm[1, yj] ^ tt.perlin_perm[2, zk]
                c = tt.perlin_randvec[h]  # [..., 3]
                weight_v = uvw - torch.tensor([di, dj, dk], dtype=p.dtype, device=p.device)
                w = ((di * uu[..., 0] + (1 - di) * (1 - uu[..., 0]))
                     * (dj * uu[..., 1] + (1 - dj) * (1 - uu[..., 1]))
                     * (dk * uu[..., 2] + (1 - dk) * (1 - uu[..., 2])))
                accum = accum + w * torch.sum(c * weight_v, dim=-1)
    return accum


def _perlin_turb(tt: TextureTable, p, depth: int = 7):
    """perlin::turb (perlin.h:38-50)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    temp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * _perlin_noise(tt, temp_p)
        weight = weight * 0.5
        temp_p = temp_p * 2.0
    return torch.abs(accum)


def texture_value(tt: TextureTable, tex_id, u, v, p, with_noise: bool = True):
    """Batched texture::value.  tex_id [...] >= 0, u, v [...], p [..., 3];
    returns [..., 3].  ``with_noise``: evaluate the perlin turbulence (the
    costly part; scenes without a noise texture leave it out)."""
    kind = tt.kind[tex_id]
    c0 = tt.color0[tex_id]
    c1 = tt.color1[tex_id]
    scale = tt.scale[tex_id]

    # solid (texture.h:20-22)
    out = c0

    # checker (texture.h:37-46): integer-floor parity in world space
    inv_scale = torch.where(scale != 0, 1.0 / scale, 0.0)
    fl = torch.floor(inv_scale[..., None] * p).to(torch.int64)
    is_even = (fl[..., 0] + fl[..., 1] + fl[..., 2]) % 2 == 0
    checker = torch.where(is_even[..., None], c0, c1)
    out = torch.where((kind == TEX_CHECKER)[..., None], checker, out)

    # image (texture.h:57-73): clamp uv, flip v, nearest neighbour, /255
    iid = tt.img_id[tex_id]
    w_img = tt.img_w[iid]
    h_img = tt.img_h[iid]
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)
    xi = torch.minimum(torch.clamp_min((uc * w_img.to(u.dtype)).to(torch.int64), 0), w_img - 1)
    yj = torch.minimum(torch.clamp_min((vc * h_img.to(v.dtype)).to(torch.int64), 0), h_img - 1)
    texel = tt.images[iid, yj, xi] * (1.0 / 255.0)
    out = torch.where((kind == TEX_IMAGE)[..., None], texel, out)

    # noise (texture.h:82-84): 0.5 * (1 + sin(scale * z + 10 * turb(p, 7)))
    if with_noise:
        turb = _perlin_turb(tt, p, 7)
        noise = 0.5 * (1.0 + torch.sin(scale * p[..., 2] + 10.0 * turb))
        out = torch.where((kind == TEX_NOISE)[..., None], noise[..., None], out)
    return out
