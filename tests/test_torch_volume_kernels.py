"""The plain versions of the volume kernels on bpt_tpu_torch against
bpt_tpu's jnp estimator at f32 with injected draws on the smoke cornell
box: ``pt_megakernel_plain`` ([depth*(NU+V), B] draws) and
``bdpt_megakernel_plain`` ([n_uniform_slots(depth, V), B]), as bpt_tpu
holds its own volume kernels (tests/test_pallas_kernels.py:1058-1131);
and the wave's texel stage on volume lanes.

Tolerances: rtol 1e-4 with atol 1e-6 (PT) or 1e-5 (BDPT), rays equal,
BDPT shadow rays within 1% (XLA's CPU arithmetic decides a few grazing
connections: ROADMAP §3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import bdpt as jbdpt
from bpt_tpu.models import pt as jpt
from bpt_tpu.scene import builder as jbuilder
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.models import bdpt as tbdpt
from bpt_tpu_torch.models import pt as tpt
from bpt_tpu_torch.ops.kernels import bdpt_kernel as tbk
from bpt_tpu_torch.ops.kernels import pt_kernel as tk
from bpt_tpu_torch.ops.kernels import pt_wave as tw
from bpt_tpu_torch.scene import builder as tbuilder
from bpt_tpu_torch.scene import textures as ttex
from torch_parity import box_rays, smoke_scene, volume_big_scene


@pytest.fixture(scope="module")
def smoke32():
    return smoke_scene(jbuilder, dtype=jnp.float32), smoke_scene(tbuilder, device="cpu")


def test_pt_megakernel_plain_volumes_injected(smoke32):
    """pt_megakernel_plain with injected [depth*(NU+V), B] draws against
    bpt_tpu's jnp estimator (test_megakernel_volumes_match_jnp_injected)."""
    js, ts = smoke32
    B, depth, nu = 160, 5, tpt.NU + 2
    o, d = box_rays(B, 65, np.float32)
    U = np.random.default_rng(12).uniform(size=(B, depth, nu)).astype(np.float32)
    ubuf = torch.from_numpy(U).permute(1, 2, 0).reshape(depth * nu, B)
    ids = torch.arange(B, dtype=torch.int32)
    ids[::9] = -1
    live = ids.numpy() >= 0
    want, st = jpt.path_trace_radiance(js, jnp.asarray(o[live]), jnp.asarray(d[live]), depth,
                                       jpt.array_uniforms_fn(jnp.asarray(U[live])))
    out = tk.pt_megakernel_plain(ts, Vec3(*torch.from_numpy(o).unbind(1)),
                                 Vec3(*torch.from_numpy(d).unbind(1)), ids, rng.prng_key(0),
                                 depth, uniforms=ubuf)
    got = torch.stack(out[:3], -1).numpy()
    np.testing.assert_allclose(got[live], np.asarray(want), rtol=1e-4, atol=1e-6)
    assert not got[~live].any() and float(got.sum()) > 0
    assert int(out[3]) == int(st.rays_traced)


@pytest.mark.parametrize("mis", [False, True], ids=["bdpt", "bdpt-mis"])
def test_bdpt_megakernel_plain_volumes_injected(smoke32, mis):
    """bdpt_megakernel_plain with injected [n_uniform_slots(depth, V), B]
    draws against bpt_tpu's jnp estimator
    (test_bdpt_megakernel_volumes_match_jnp_injected's layout)."""
    js, ts = smoke32
    B, depth, V = 96, 4, 2
    ntv = tbdpt.NT + V
    o, d = box_rays(B, 23 + int(mis), np.float32)
    g = np.random.default_rng(29 + int(mis))
    cam_u = g.uniform(size=(B, depth, ntv)).astype(np.float32)
    ls_u = g.uniform(size=(B, tbdpt.NLS)).astype(np.float32)
    light_u = g.uniform(size=(B, depth - 1, ntv)).astype(np.float32)
    want, st = jbdpt.bdpt_radiance(
        js, jnp.asarray(o), jnp.asarray(d), depth, jpt.array_uniforms_fn(jnp.asarray(cam_u)),
        jnp.asarray(ls_u), jpt.array_uniforms_fn(jnp.asarray(light_u)), mis=mis)
    rows = ([cam_u[:, b, s] for b in range(depth) for s in range(ntv)]
            + [ls_u[:, s] for s in range(tbdpt.NLS)]
            + [light_u[:, b, s] for b in range(depth - 1) for s in range(ntv)])
    ubuf = torch.from_numpy(np.stack(rows))
    assert ubuf.shape[0] == tbk.n_uniform_slots(depth, V)
    out = tbk.bdpt_megakernel_plain(ts, Vec3(*torch.from_numpy(o).unbind(1)),
                                    Vec3(*torch.from_numpy(d).unbind(1)),
                                    torch.arange(B, dtype=torch.int32), rng.prng_key(0), depth,
                                    uniforms=ubuf, mis=mis)
    np.testing.assert_allclose(torch.stack(out[:3], -1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert int(out[3]) == int(st.rays_traced)
    assert abs(int(out[4]) - int(st.shadow_rays)) <= max(5, int(st.shadow_rays) // 100)


def test_texel_stage_reads_volume_lanes():
    """texel_stage on a volume lane (tri = -2 - phase material) multiplies
    its throughput by the texel at (0, 0, p); -1 (a miss) is left alone."""
    ts = volume_big_scene(tbuilder, texture=ttex.TextureSpec.checker(
        0.35, (0.9, 0.3, 0.2), (0.2, 0.4, 0.9)), device="cpu")
    vmat = int(ts.vol_mat[0])
    B = 4
    state = torch.zeros((tw.STATE_ROWS, B))
    state[tw.OX:tw.OX + 3] = torch.tensor([[0.1, 0.2, 0.3, 0.4]] * 3)
    state[tw.THR:tw.THR + 3] = 1.0
    state[tw.ALIVE] = 1.0
    tri = torch.tensor([-2 - vmat, -1, -2 - vmat, 0], dtype=torch.int32)
    zero = torch.zeros(B)
    tw.texel_stage(ts, state, tri, zero, zero)
    want = ttex.texture_value(ts.textures, ts.materials.tex_id[[vmat]].expand(B), zero, zero,
                              state[tw.OX:tw.OX + 3].T)
    np.testing.assert_array_equal(state[tw.THR:tw.THR + 3, 0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(state[tw.THR:tw.THR + 3, 1].numpy(), [1.0, 1.0, 1.0])
