"""The PT megakernel's threefry stream, bit-exact with ``bpt_tpu``.

Every draw is ``bits_to_unit_float(threefry2x32(k_slot, (ray_id, bounce)))``
with per-slot keys derived by ``fold_in`` from the render key, so an image
is identical across runs, chunk sizes and launch shapes.  Keys are plain
``(k1, k2)`` tuples of Python ints: ``prng_key`` and ``fold_in`` reproduce
``jax.random.PRNGKey`` and ``jax.random.fold_in`` (threefry2x32 impl)
without JAX.  torch has thin uint32 support, so words are int64 tensors
holding values in [0, 2^32), masked after every add and shift.

The BDPT megakernel has a stream of its own (``subkeys_bdpt``): one key
per (section, bounce, slot), the counter ``(ray_id, 0)``, and word x0 of
every call.  A scene with V volumes adds V free-flight slots to every
bounce of both streams (PT: slots NU..NU+V-1, single draws).

The jnp wavefront's stream (``wave_uniforms`` / ``uniform_rows``, the
counterparts of ``bpt_tpu.core.rng``'s) is a third one, the stream of
``jax.random`` itself with ``jax_threefry_partitionable``: each lane's key
is ``fold_in(fold_in(key, bounce), ray_id)`` and its draw ``i`` comes from
``threefry2x32(lane_key, (0, i))``, both words folded into the float.  The
large-scene BDPT route draws from it.
"""

from __future__ import annotations

from functools import lru_cache

import torch

MASK32 = 0xFFFFFFFF
NU = 9  # uniform slots per bounce (models.pt layout)
BDPT_NT = 5  # BDPT trace slots per bounce (models.bdpt TU_*)
BDPT_NLS = 5  # BDPT light-start slots (models.bdpt LS_*)

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(k1, k2, x0, x1):
    """One threefry2x32 block (jax._src.prng._threefry2x32_lowering).

    Works on Python ints and on int64 tensors holding uint32 values alike.
    """
    ks2 = k1 ^ k2 ^ 0x1BD11BDA
    x0 = (x0 + k1) & MASK32
    x1 = (x1 + k2) & MASK32
    x0, x1 = _rounds(x0, x1, _ROT_A)
    x0 = (x0 + k2) & MASK32
    x1 = (x1 + ks2 + 1) & MASK32
    x0, x1 = _rounds(x0, x1, _ROT_B)
    x0 = (x0 + ks2) & MASK32
    x1 = (x1 + k1 + 2) & MASK32
    x0, x1 = _rounds(x0, x1, _ROT_A)
    x0 = (x0 + k1) & MASK32
    x1 = (x1 + k2 + 3) & MASK32
    x0, x1 = _rounds(x0, x1, _ROT_B)
    x0 = (x0 + k2) & MASK32
    x1 = (x1 + ks2 + 4) & MASK32
    x0, x1 = _rounds(x0, x1, _ROT_A)
    x0 = (x0 + ks2) & MASK32
    x1 = (x1 + k1 + 5) & MASK32
    return x0, x1


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor) -> f32 in [0, 1): the mantissa trick."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the pair (seed >> 32, seed & mask)."""
    return ((seed >> 32) & MASK32, seed & MASK32)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: one threefry block on the counter (0, data)."""
    return threefry2x32(key[0], key[1], 0, data & MASK32)


def subkeys(key: tuple[int, int], nu: int = NU) -> list[int]:
    """Per-SLOT keys ``fold_in(key, s)`` flattened to [2*nu] words
    (pt_kernel._subkeys); the bounce rides in the threefry counter."""
    out: list[int] = []
    for s in range(nu):
        out.extend(fold_in(key, s))
    return out


def subkeys_with_raygen(key: tuple[int, int], nu: int = NU) -> list[int]:
    """Slot keys off ``fold_in(key, 1)`` (STREAM_PT) + the two jitter keys
    ``fold_in(fold_in(key, 0), 0|1)`` (STREAM_RAYGEN):
    pt_kernel._subkeys_with_raygen."""
    kg = fold_in(key, 0)
    return subkeys(fold_in(key, 1), nu) + list(fold_in(kg, 0)) + list(fold_in(kg, 1))


def raygen_jitter(key: tuple[int, int], ray_ids: torch.Tensor, defocus: bool = False):
    """The megakernel's stratified-jitter pair: ONE threefry call at
    counter (ray id, 0) off ``fold_in(fold_in(key, STREAM_RAYGEN=0), 0)``,
    both words (bpt_tpu's render._raygen_jitter_host).  ``defocus=True``
    returns four uniforms: the defocus-disk pair is a second call at
    counter (ray id, 1), and the jitter pair stays the same."""
    k = fold_in(fold_in(key, 0), 0)
    ridu = ray_words(ray_ids)
    b0, b1 = threefry2x32(k[0], k[1], ridu, torch.zeros_like(ridu))
    if not defocus:
        return bits_to_unit_float(b0), bits_to_unit_float(b1)
    d0, d1 = threefry2x32(k[0], k[1], ridu, torch.ones_like(ridu))
    return tuple(bits_to_unit_float(x) for x in (b0, b1, d0, d1))


def ray_words(ray_ids: torch.Tensor) -> torch.Tensor:
    """int ray ids -> int64 uint32 words (the kernels' ``astype(uint32)``)."""
    return ray_ids.to(torch.int64) & MASK32


# ------------------------------------------------------------- jnp stream


def uniform_rows(key: tuple[int, int], ray_ids: torch.Tensor, bounce: int, n: int,
                 dtype=torch.float32) -> list[torch.Tensor]:
    """``bpt_tpu.core.rng.uniform_rows``: n rows of [B] uniforms in [0, 1),
    ``jax.random.uniform(fold_in(fold_in(key, bounce), ray_id), (n,))`` per
    lane.  The lane keys are tensors: ``threefry2x32(kb, (0, ray_id))``.
    Draw i is ``threefry2x32(lane_key, (0, i)) = (x0, x1)``; float32 takes
    the mantissa trick on ``x0 ^ x1``, float64 the top 52 bits of
    ``(x0 << 32) | x1``, i.e. ``(x0 << 20) | (x1 >> 12)``."""
    kb = fold_in(key, bounce)
    rid = ray_words(ray_ids)
    k1, k2 = threefry2x32(kb[0], kb[1], torch.zeros_like(rid), rid)
    rows = []
    for i in range(n):
        x0, x1 = threefry2x32(k1, k2, 0, i)
        if dtype == torch.float64:
            rows.append(((x0 << 20) | (x1 >> 12)).to(torch.float64) * 2.0 ** -52)
        else:
            rows.append(bits_to_unit_float(x0 ^ x1).to(dtype))
    return rows


def wave_uniforms(key: tuple[int, int], ray_ids: torch.Tensor, bounce: int, n: int,
                  dtype=torch.float32) -> torch.Tensor:
    """``bpt_tpu.core.rng.wave_uniforms``: the same draws as [B, n]."""
    return torch.stack(uniform_rows(key, ray_ids, bounce, n, dtype), dim=-1)


# ------------------------------------------------------------ BDPT stream


def n_uniform_slots(depth: int, n_vols: int = 0) -> int:
    """Uniform rows of one BDPT sample (bdpt_kernel.n_uniform_slots):
    camera trace depth x (NT + V), light start NLS, light trace
    (depth-1) x (NT + V); a trace bounce's V free-flight draws, one a
    volume, follow its NT slots."""
    ntv = BDPT_NT + n_vols
    return depth * ntv + BDPT_NLS + max(depth - 1, 0) * ntv


@lru_cache(maxsize=16)
def _bdpt_keys(key: tuple[int, int], depth: int, n_vols: int = 0) -> tuple:
    k_cam, k_ls, k_lt = fold_in(key, 2), fold_in(key, 3), fold_in(key, 4)
    ntv = BDPT_NT + n_vols
    ks = []
    for b in range(depth):
        kb = fold_in(k_cam, b)
        ks.extend(fold_in(kb, s) for s in range(ntv))
    ks.extend(fold_in(k_ls, s) for s in range(BDPT_NLS))
    for b in range(max(depth - 1, 0)):
        kb = fold_in(k_lt, b)
        ks.extend(fold_in(kb, s) for s in range(ntv))
    return tuple(ks)


def subkeys_bdpt(key: tuple[int, int], depth: int, n_vols: int = 0) -> list[int]:
    """Per-slot keys of the BDPT kernel stream, flattened to
    [2 * n_uniform_slots(depth, n_vols)] words (bdpt_kernel._subkeys_bdpt):
    slot s of camera bounce b is ``fold_in(fold_in(fold_in(key, 2), b), s)``,
    of the light start ``fold_in(fold_in(key, 3), s)``, of light bounce b
    ``fold_in(fold_in(fold_in(key, 4), b), s)``; a trace bounce has NT +
    n_vols slots, the free-flight draws last."""
    return [w for k in _bdpt_keys(tuple(key), depth, n_vols) for w in k]


def subkeys_bdpt_raygen(key: tuple[int, int], depth: int, n_vols: int = 0) -> list[int]:
    """subkeys_bdpt + the two jitter keys ``fold_in(fold_in(key, 0), 0|1)``
    (bdpt_kernel._subkeys_bdpt_raygen)."""
    kg = fold_in(key, 0)
    return (subkeys_bdpt(key, depth, n_vols) + list(fold_in(kg, 0))
            + list(fold_in(kg, 1)))


def _x0(k: tuple[int, int], ridw: torch.Tensor) -> torch.Tensor:
    b0, _ = threefry2x32(k[0], k[1], ridw, torch.zeros_like(ridw))
    return bits_to_unit_float(b0)


def bdpt_raygen_jitter(key: tuple[int, int], ray_ids: torch.Tensor):
    """BDPT's stratified-jitter pair: word x0 of TWO threefry calls at
    counter (rid, 0), keyed ``fold_in(fold_in(key, 0), 0)`` and
    ``fold_in(fold_in(key, 0), 1)`` (bdpt_kernel.py:994-997).  PT's
    ``raygen_jitter`` takes both words of one call instead."""
    kg = fold_in(key, 0)
    ridw = ray_words(ray_ids)
    return _x0(fold_in(kg, 0), ridw), _x0(fold_in(kg, 1), ridw)


def bdpt_kernel_stream_uniforms_fn(key, ray_ids: torch.Tensor, depth: int, dtype,
                                   n_vols: int = 0):
    """The BDPT megakernel's in-kernel stream as the wavefront's uniform
    sources: ``(cam_fn, light_start_rows, light_fn)`` for
    ``models.bdpt.bdpt_radiance``.  ``cam_fn(b, n)`` / ``light_fn(b, n)``
    give n <= NT + n_vols rows of [B] for trace bounce b; ``light_start_rows``
    is the NLS rows of the light start.  Every draw is x0 of its own
    threefry call at counter (rid, 0)."""
    keys = _bdpt_keys(tuple(key), depth, n_vols)
    ridw = ray_words(ray_ids)
    ntv, nls = BDPT_NT + n_vols, BDPT_NLS

    def rows(base, n):
        return [_x0(keys[base + s], ridw).to(dtype) for s in range(n)]

    def cam_fn(b, n):
        return rows(b * ntv, n)

    def light_fn(b, n):
        return rows(depth * ntv + nls + b * ntv, n)

    return cam_fn, rows(depth * ntv, nls), light_fn
