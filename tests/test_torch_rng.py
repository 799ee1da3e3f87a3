"""bpt_tpu_torch.core.rng against bpt_tpu: the PT megakernel's threefry
stream must be bit-equal (words, keys, subkeys, uniform rows, jitter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import pt as jpt
from bpt_tpu.models.render import _raygen_jitter_host
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.models import pt as tpt


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)


def _key_words(key):
    return tuple(int(x) for x in np.asarray(key))  # legacy uint32[2] key


@pytest.mark.parametrize("seed", [0, 1])
def test_threefry_words_bitequal(seed):
    k = _words(2, seed)
    x0, x1 = _words(257, seed + 10), _words(257, seed + 20)
    want = jk._threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]),
                            jnp.asarray(x0, jnp.uint32), jnp.asarray(x1, jnp.uint32))
    got = rng.threefry2x32(int(k[0]), int(k[1]),
                           torch.from_numpy(x0.astype(np.int64)),
                           torch.from_numpy(x1.astype(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())


def test_bits_to_unit_float_bitequal():
    bits = _words(1000, 3)
    bits[:4] = [0, 1 << 9, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jk._bits_to_unit_float(jnp.asarray(bits, jnp.uint32)))
    got = rng.bits_to_unit_float(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**33 + 5])
def test_prng_key_and_fold_in_bitequal(seed):
    key = jax.random.PRNGKey(seed)
    assert _key_words(key) == rng.prng_key(seed)
    for d in (0, 1, 2, 12345):
        assert _key_words(jax.random.fold_in(key, d)) == rng.fold_in(
            rng.prng_key(seed), d)


@pytest.mark.parametrize("with_raygen", [False, True])
def test_subkeys_bitequal(with_raygen):
    key = jax.random.PRNGKey(11)
    fn_j = jk._subkeys_with_raygen if with_raygen else jk._subkeys
    fn_t = rng.subkeys_with_raygen if with_raygen else rng.subkeys
    want = [int(x) for x in np.asarray(fn_j(key, jk.NU))]
    assert want == fn_t(rng.prng_key(11), rng.NU)


@pytest.mark.parametrize("bounce", [0, 3])
def test_kernel_stream_uniform_rows_bitequal(bounce):
    ids = np.random.default_rng(5).integers(0, 2**31 - 1, 300).astype(np.int32)
    fj = jpt.kernel_stream_uniforms_fn(jax.random.PRNGKey(3), jnp.asarray(ids),
                                       jnp.float32)
    ft = tpt.kernel_stream_uniforms_fn(rng.prng_key(3), torch.from_numpy(ids),
                                       torch.float32)
    rows_j, rows_t = fj(bounce, jpt.NU), ft(bounce, tpt.NU)
    assert len(rows_j) == len(rows_t) == jpt.NU
    for rj, rt in zip(rows_j, rows_t):
        np.testing.assert_array_equal(np.asarray(rj).view(np.uint32),
                                      rt.numpy().view(np.uint32))


def test_raygen_jitter_bitequal():
    ids = np.arange(0, 4096 * 16, 7, dtype=np.int32)
    want = _raygen_jitter_host(jax.random.PRNGKey(9), jnp.asarray(ids))
    got = rng.raygen_jitter(rng.prng_key(9), torch.from_numpy(ids))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).view(np.uint32),
                                      g.numpy().view(np.uint32))
