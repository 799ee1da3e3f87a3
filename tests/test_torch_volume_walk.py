"""The plain walk mode and the plain wave of bpt_tpu_torch on the
964-triangle scene with a constant-density box (tests/
test_pallas_kernels.py:1189-1231) against bpt_tpu's jnp estimator at f32:
``pt_megakernel_plain`` and ``bdpt_megakernel_plain`` over the torch BVH
walk with injected draws, and ``pt_wave_plain`` (untextured, and with a
checker on the volume's phase function) on the kernels' stream
(``kernel_stream_uniforms_fn`` with n_vols).

Tolerances: rtol 1e-4 / atol 1e-5 (bpt_tpu's for its clustered volume
kernel, and the textured wave's: its texel stage multiplies the texel in
after the bounce), 1e-6 for the untextured wave; rays equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import bdpt as jbdpt
from bpt_tpu.models import pt as jpt
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu.scene import textures as jtex
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.ops.kernels import bdpt_kernel as tbk
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import textures as ttex
from torch_parity import volume_big_scene


@pytest.mark.parametrize("estimator", ["pt", "bdpt-mis"])
def test_walk_mode_plain_volumes_injected(estimator):
    """The plain walk mode (over the torch BVH walk) on the 964-triangle
    scene with a volume box (bpt_tpu's test_clustered_megakernel_with_
    volumes) against bpt_tpu's jnp estimator."""
    js = volume_big_scene(jbuilder, dtype=jnp.float32)
    ts = volume_big_scene(tbuilder, device="cpu")
    assert tk.use_walk(ts) and ts.num_volumes == 1 and not tk.megakernel_reject_reason(ts)
    B, depth = 96, 3
    g = np.random.default_rng(55)
    o = np.tile([[0.0, 2.0, 6.0]], (B, 1)).astype(np.float32)
    tgt = np.c_[g.uniform(-2, 2, B), g.uniform(0, 3, B), np.zeros(B)]
    d = (tgt - o).astype(np.float32)
    ov, dv = Vec3(*torch.from_numpy(o).unbind(1)), Vec3(*torch.from_numpy(d).unbind(1))
    ids = torch.arange(B, dtype=torch.int32)
    if estimator == "pt":
        U = g.uniform(size=(B, depth, tpt.NU + 1)).astype(np.float32)
        want, st = jpt.path_trace_radiance(js, jnp.asarray(o), jnp.asarray(d), depth,
                                           jpt.array_uniforms_fn(jnp.asarray(U)))
        out = tk.pt_megakernel_plain(ts, ov, dv, ids, rng.prng_key(0), depth,
                                     uniforms=torch.from_numpy(U).permute(1, 2, 0).reshape(-1, B))
    else:
        ntv = tbdpt.NT + 1
        cam_u = g.uniform(size=(B, depth, ntv)).astype(np.float32)
        ls_u = g.uniform(size=(B, tbdpt.NLS)).astype(np.float32)
        light_u = g.uniform(size=(B, depth - 1, ntv)).astype(np.float32)
        want, st = jbdpt.bdpt_radiance(
            js, jnp.asarray(o), jnp.asarray(d), depth,
            jpt.array_uniforms_fn(jnp.asarray(cam_u)), jnp.asarray(ls_u),
            jpt.array_uniforms_fn(jnp.asarray(light_u)), mis=True)
        rows = ([cam_u[:, b, s] for b in range(depth) for s in range(ntv)]
                + [ls_u[:, s] for s in range(tbdpt.NLS)]
                + [light_u[:, b, s] for b in range(depth - 1) for s in range(ntv)])
        out = tbk.bdpt_megakernel_plain(ts, ov, dv, ids, rng.prng_key(0), depth,
                                        uniforms=torch.from_numpy(np.stack(rows)), mis=True)
    np.testing.assert_allclose(torch.stack(out[:3], -1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert float(np.asarray(want).sum()) > 0 and int(out[3]) == int(st.rays_traced)


@pytest.mark.parametrize("textured", [False, True], ids=["untextured", "textured"])
def test_pt_wave_plain_volumes_match_bpt_tpu(textured):
    """pt_wave_plain on the 964-triangle scene with a volume box (a checker
    on its phase function when textured: the shade marks volume lanes and
    the texel stage reads their texel at (0, 0, p)) against bpt_tpu's jnp
    wavefront on the kernels' stream (kernel_stream_uniforms_fn with
    n_vols)."""
    tex = dict(jmod=jtex.TextureSpec.checker(0.35, (0.9, 0.3, 0.2), (0.2, 0.4, 0.9)),
               tmod=ttex.TextureSpec.checker(0.35, (0.9, 0.3, 0.2), (0.2, 0.4, 0.9)))
    js = volume_big_scene(jbuilder, texture=tex["jmod"] if textured else None,
                          dtype=jnp.float32)
    ts = volume_big_scene(tbuilder, texture=tex["tmod"] if textured else None, device="cpu")
    assert ts.has_textures == textured and not tk.shade_reject_reason(ts)
    B, depth = 160, 4
    g = np.random.default_rng(71 + int(textured))
    o = np.tile([[0.0, 2.0, 6.0]], (B, 1)).astype(np.float32)
    d = (np.c_[g.uniform(-2, 2, B), g.uniform(0, 3, B), np.zeros(B)] - o).astype(np.float32)
    ids = np.arange(B, dtype=np.int32)
    want, st = jpt.path_trace_radiance(
        js, jnp.asarray(o), jnp.asarray(d), depth,
        jpt.kernel_stream_uniforms_fn(jax.random.PRNGKey(17), jnp.asarray(ids), jnp.float32,
                                      n_vols=1))
    rx, ry, rz, rays_, extra = tw.pt_wave_plain(
        ts, Vec3(*torch.from_numpy(o).unbind(1)), Vec3(*torch.from_numpy(d).unbind(1)),
        torch.from_numpy(ids), rng.prng_key(17), depth)
    got = torch.stack([rx, ry, rz], -1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                               atol=1e-5 if textured else 1e-6)
    assert float(got.sum()) > 0 and int(rays_) == int(st.rays_traced)
    if textured:  # the texel is read: the same paths untextured give another image
        flat = dataclasses.replace(ts, has_textures=False)
        other = tw.pt_wave_plain(flat, Vec3(*torch.from_numpy(o).unbind(1)),
                                 Vec3(*torch.from_numpy(d).unbind(1)),
                                 torch.from_numpy(ids), rng.prng_key(17), depth)
        assert not np.allclose(torch.stack(other[:3], -1).numpy(), got)
