"""The whole slice: bpt_tpu_torch's render() and CLI against bpt_tpu's
fused PT and BDPT main paths (render.py:157-224 composed with the Pallas
pt_megakernel_pixels / bdpt_megakernel_pixels in interpret mode), plus
chunking, checkpoints, film and the no-JAX import rule.

BDPT tolerance: rtol 1e-4 / atol 1e-5 on >= 90% of pixels, rays and
triangle hits exact, shadow rays within 1%.  A few connections on the
cornell box graze a wall or re-hit their own surface just past T_MIN and
flip on a one-ulp difference between XLA's and PyTorch's CPU arithmetic
(test_torch_bdpt.py says how); each flip moves one pixel of this 4-spp
image."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.models import camera as jcam
from bpt_tpu.ops import film as jfilm
from bpt_tpu.ops.pallas import bdpt_kernel as jbk
from bpt_tpu.ops.pallas import pt_kernel as jk
from bpt_tpu.scene import presets as jpresets
from bpt_tpu_torch import render as cli
from bpt_tpu_torch.models.render import render
from bpt_tpu_torch.ops import film as tfilm
from bpt_tpu_torch.scene import presets as tpresets
from bpt_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from bpt_tpu_torch.utils.png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, SPP, DEPTH, SEED = 8, 4, 3, 7


def _cfg(presets, integrator="pt", **kw):
    kw = dict(dict(image_width=W, samples_per_pixel=SPP, max_depth=DEPTH), **kw)
    return dataclasses.replace(presets.cornell_box_camera(), integrator=integrator, **kw)


@pytest.fixture(scope="module")
def port_result():
    return render(tpresets.cornell_box(device="cpu"), _cfg(tpresets), seed=SEED)


def _jax_main_path():
    """bpt_tpu's _make_step_pt_fused body for the one chunk that covers
    the 8x8 image (chunk size min(2^18, max(1024, 64)) clipped to 64)."""
    scene = jpresets.cornell_box(dtype=jnp.float32)
    cc = jcam.camera_constants(_cfg(jpresets), jnp.float32)
    npix, S = W * W, 2
    pix = jnp.arange(npix, dtype=jnp.int32)
    in_range = pix < npix
    pixc = jnp.minimum(pix, npix - 1)
    i = (pixc % W).astype(jnp.float32)
    j = (pixc // W).astype(jnp.float32)
    rx, ry, rz, rays, extra = jk.pt_megakernel_pixels(
        scene, i, j, i * 0, j * 0, jnp.where(in_range, pixc, -1),
        jk.camera_table(cc), jax.random.PRNGKey(SEED), DEPTH,
        interpret=True, spp_loop=S * S, sqrt_spp=S)
    rad = jnp.where(in_range[..., None], jnp.stack([rx, ry, rz], axis=-1), 0.0)
    fb = jnp.zeros((npix, 3), jnp.float32).at[pixc].add(rad)
    return np.asarray(fb).reshape(W, W, 3), int(rays), np.asarray(extra)


def test_render_matches_jax_main_path(port_result):
    fb, rays, extra = _jax_main_path()
    np.testing.assert_allclose(port_result.framebuffer_sum, fb, rtol=1e-4, atol=1e-6)
    s = port_result.stats
    assert s.rays_traced == rays > 0
    assert [s.bvh_node_visits, s.aabb_hits, s.triangle_tests, s.triangle_hits] == [
        int(x) for x in extra]
    assert port_result.samples_per_pixel == SPP
    assert port_result.rgb8().shape == (W, W, 3)


def _jax_main_path_bdpt(mis):
    """bpt_tpu's _make_step_bdpt_fused body for the one chunk that covers
    the 8x8 image."""
    scene = jpresets.cornell_box(dtype=jnp.float32)
    cc = jcam.camera_constants(_cfg(jpresets, "bdpt"), jnp.float32)
    npix = W * W
    pix = jnp.arange(npix, dtype=jnp.int32)
    in_range = pix < npix
    pixc = jnp.minimum(pix, npix - 1)
    i = (pixc % W).astype(jnp.float32)
    j = (pixc // W).astype(jnp.float32)
    rx, ry, rz, rays, shadow, extra = jbk.bdpt_megakernel_pixels(
        scene, i, j, jnp.where(in_range, pixc, -1), jk.camera_table(cc),
        jax.random.PRNGKey(SEED), DEPTH, 2, interpret=True, mis=mis)
    rad = jnp.where(in_range[..., None], jnp.stack([rx, ry, rz], axis=-1), 0.0)
    fb = jnp.zeros((npix, 3), jnp.float32).at[pixc].add(rad)
    return np.asarray(fb).reshape(W, W, 3), int(rays), int(shadow), np.asarray(extra)


@pytest.fixture(scope="module")
def port_bdpt():
    return render(tpresets.cornell_box(device="cpu"), _cfg(tpresets, "bdpt"), seed=SEED)


@pytest.mark.parametrize("integrator", ["bdpt", "bdpt-mis"])
def test_render_bdpt_matches_jax_main_path(integrator, port_bdpt):
    res = (port_bdpt if integrator == "bdpt" else
           render(tpresets.cornell_box(device="cpu"), _cfg(tpresets, integrator), seed=SEED))
    fb, rays, shadow, extra = _jax_main_path_bdpt(integrator == "bdpt-mis")
    ok = np.isclose(res.framebuffer_sum, fb, rtol=1e-4, atol=1e-5).all(-1)
    assert ok.mean() >= 0.9, np.argwhere(~ok)
    s = res.stats
    assert s.rays_traced == rays > 0
    assert s.triangle_hits == int(extra[3]) > 0
    assert shadow > 0 and abs(s.shadow_rays - shadow) <= 0.01 * shadow
    assert s.triangle_tests > s.rays_traced * 24
    assert np.isfinite(res.framebuffer_sum).all() and res.rgb8().shape == (W, W, 3)


@pytest.mark.parametrize("chunk", [7, 24])
def test_render_bdpt_chunk_size_invariance(port_bdpt, chunk):
    r = render(tpresets.cornell_box(device="cpu"), _cfg(tpresets, "bdpt"), seed=SEED, chunk_size=chunk)
    np.testing.assert_array_equal(r.framebuffer_sum, port_bdpt.framebuffer_sum)
    assert dataclasses.replace(r.stats, wall_seconds=0) == dataclasses.replace(
        port_bdpt.stats, wall_seconds=0)


@pytest.mark.parametrize("chunk", [7, 24])
def test_render_chunk_size_invariance(port_result, chunk):
    r = render(tpresets.cornell_box(device="cpu"), _cfg(tpresets), seed=SEED, chunk_size=chunk)
    np.testing.assert_array_equal(r.framebuffer_sum, port_result.framebuffer_sum)
    assert dataclasses.replace(r.stats, wall_seconds=0) == dataclasses.replace(
        port_result.stats, wall_seconds=0)


def test_chunk_checkpoint_resume_bitwise(port_result, tmp_path):
    path = str(tmp_path / "ck.npz")
    snaps = []
    render(tpresets.cornell_box(device="cpu"), _cfg(tpresets), seed=SEED, chunk_size=16,
           stratum_callback=lambda st: snaps.append(st))
    assert [s["units_done"] for s in snaps] == [1, 2, 3, 4]
    save_checkpoint(path, snaps[1])  # interrupted after 2 of 4 chunks
    resume = load_checkpoint(path)
    assert resume["unit_kind"] == "chunk" and resume["chunk_size"] == 16
    r = render(tpresets.cornell_box(device="cpu"), _cfg(tpresets), seed=SEED, chunk_size=16,
               resume=resume)
    np.testing.assert_array_equal(r.framebuffer_sum, port_result.framebuffer_sum)
    with pytest.raises(ValueError, match="chunk_size=16"):
        render(tpresets.cornell_box(device="cpu"), _cfg(tpresets), seed=SEED, chunk_size=8,
               resume=resume)
    with pytest.raises(ValueError, match="stratum"):  # pt_wave's stream
        render(tpresets.cornell_box(device="cpu"), _cfg(tpresets), seed=SEED,
               resume=dict(resume, unit_kind="stratum", stream="wave"))


@pytest.mark.parametrize("spp", [1, 16])
def test_to_rgb8_matches_jax(spp):
    fb = np.random.default_rng(spp).normal(0.3, 0.6, (16, 16, 3)).astype(np.float32) * spp
    fb[0, :3] = [np.nan, np.inf, -np.inf]
    want = np.asarray(jfilm.to_rgb8(jnp.asarray(fb), spp))
    got = tfilm.to_rgb8(torch.from_numpy(fb), spp).numpy()
    np.testing.assert_array_equal(got, want)


def test_render_rejects_unported_configurations():
    """BDPT past the kernel's depth bound and an unknown integrator refuse.
    Volumes, refused until they were ported, render: the smoke cornell box
    with defocus through the stratum loop (which takes every small scene
    the fused loop does not: defocus, ref_vis, float64, textures) equal to
    bpt_tpu's jnp estimators on the same rays and draws."""
    from bpt_tpu.models import pt as jpt
    from bpt_tpu.scene import builder as jbuilder
    from bpt_tpu_torch.models import pt as tpt
    from bpt_tpu_torch.models.render import _route
    from bpt_tpu_torch.scene import builder as tbuilder
    from torch_parity import box_rays, smoke_scene

    scene = tpresets.cornell_box(device="cpu")
    smoke = smoke_scene(tbuilder, device="cpu", dtype=torch.float64)
    for integrator in ("pt", "bdpt", "bdpt-mis"):
        cfg = _cfg(tpresets, integrator, defocus_angle=1.0)
        assert _route(smoke, cfg, integrator, None) == "strata"
        res = render(smoke, cfg, seed=SEED)
        assert np.isfinite(res.framebuffer_sum).all() and res.framebuffer_sum.mean() > 0
    o, d = box_rays(64, 3)
    U = np.random.default_rng(4).uniform(size=(64, DEPTH, tpt.NU + 2))
    want, _ = jpt.path_trace_radiance(smoke_scene(jbuilder, dtype=jnp.float64), jnp.asarray(o),
                                      jnp.asarray(d), DEPTH, jpt.array_uniforms_fn(jnp.asarray(U)))
    got, _ = tpt.path_trace_radiance(smoke, torch.from_numpy(o), torch.from_numpy(d), DEPTH,
                                     tpt.array_uniforms_fn(torch.from_numpy(U)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    with pytest.raises(NotImplementedError, match="outside 1..80"):
        render(scene, _cfg(tpresets, "bdpt", max_depth=81))
    with pytest.raises(NotImplementedError, match="unknown integrator"):
        render(tpresets.cornell_box(device="cpu", dtype=torch.float64), _cfg(tpresets, "mlt"))


_NO_JAX = (
    "import sys\n"
    "import bpt_tpu_torch\n"
    "from bpt_tpu_torch.render import main\n"
    "rc = main(sys.argv[1:])\n"
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "       or m == 'bpt_tpu' or m.startswith('bpt_tpu.')]\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n"
)


@pytest.mark.parametrize("scene", ["cornell", "coffee"])
def test_cli_renders_png_without_jax(tmp_path, scene):
    """The cornell box at 8x8 / 4 spp / depth 2, and the 91,540-triangle
    coffee stand-in from its YAML at 8x8 / 1 spp / depth 2 (the fused
    route's walk mode, whose plain version walks the BVH in torch)."""
    spp = "4" if scene == "cornell" else "1"
    args = ["--device", "cpu", "--integrator", "pt", "--size", "8x8", "--spp", spp,
            "--max-depth", "2", "--output", "t.png", "--output-dir", str(tmp_path),
            "--no-progress"]
    if scene == "coffee":
        args.insert(0, os.path.join(ROOT, "scenes", "coffee", "coffee_standin.yaml"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    png = tmp_path / "t.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    size = dict(image_width=8, aspect_ratio=1.0, samples_per_pixel=int(spp), max_depth=2,
                integrator="pt")
    if scene == "cornell":
        sc, cam = tpresets.cornell_box(device="cpu"), tpresets.cornell_box_camera()
    else:
        from bpt_tpu_torch.scene.loader import load_scene_from_yaml

        loaded = load_scene_from_yaml(args[0], device="cpu", verbose=False)
        sc, cam = loaded.scene, loaded.camera
        assert "Triangles: 91540" in proc.stdout
        assert "nodes built:     91543" in proc.stderr
    want = render(sc, dataclasses.replace(cam, **size), seed=0).rgb8()
    np.testing.assert_array_equal(read_png(str(png)), want)
    assert want.any()
    assert "rays traced:" in proc.stderr


def test_port_never_imports_jax_or_bpt_tpu():
    """No module of bpt_tpu_torch, and not chip_smoke.py, imports JAX or
    bpt_tpu, at the top or inside a function."""
    import ast
    import glob

    files = glob.glob(os.path.join(ROOT, "bpt_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "bpt_tpu"), (path, name)


def test_cli_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "bpt_tpu_torch.render", "--device", "cpu",
         "--integrator", "pt", "--size", "4x4", "--spp", "1", "--max-depth", "1",
         "--output-dir", str(tmp_path), "--no-progress"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "cornell_box.png").exists()


def test_cli_default_renders_bdpt_without_jax(tmp_path):
    """No --integrator: the preset's BDPT, as the reference binary does."""
    args = ["--device", "cpu", "--size", "8x8", "--spp", "4", "--max-depth", "3",
            "--output-dir", str(tmp_path), "--no-progress"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = render(tpresets.cornell_box(device="cpu"), dataclasses.replace(
        tpresets.cornell_box_camera(), image_width=8, aspect_ratio=1.0,
        samples_per_pixel=4, max_depth=3), seed=0)
    np.testing.assert_array_equal(read_png(str(tmp_path / "cornell_box.png")), want.rgb8())
    assert f"shadow rays:     {want.stats.shadow_rays}" in proc.stderr
    assert want.stats.shadow_rays > 0


@pytest.mark.parametrize("argv", [
    ["scenes/cornell_smoke.yaml", "--integrator", "bdpt"],
    ["scenes/cornell_smoke.yaml", "--f64", "--integrator", "bdpt-mis"],
    ["scenes/cornell_smoke.yaml", "--integrator", "pt"],
    ["scenes/earth.yaml", "--f64", "--integrator", "pt"],
], ids=["bdpt", "bdpt-mis", "yaml", "f64"])
def test_cli_not_ported_exits_nonzero(argv, capsys, tmp_path):
    """Each feature exited non-zero until it was ported: volumes
    (cornell_smoke.yaml, with and without --f64) and the textured
    earth.yaml with --f64 render on the CPU, exit 0, and write the image
    render() gives for the same scene and flags."""
    rc = cli.main(["--device", "cpu", "--size", "4x4", "--spp", "1", "--max-depth", "3",
                   "--no-progress", "--output-dir", str(tmp_path), *argv])
    err = capsys.readouterr().err
    assert rc == 0, err
    name = os.path.splitext(os.path.basename(argv[0]))[0]
    img = read_png(str(tmp_path / f"{name}.png"))
    assert img.shape == (4, 4, 3) and img.any()
    if "earth" in argv[0]:
        return
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml

    loaded = load_scene_from_yaml(os.path.join(ROOT, argv[0]), device="cpu", verbose=False,
                                  dtype=torch.float64 if "--f64" in argv else torch.float32)
    cfg = dataclasses.replace(loaded.camera, image_width=4, aspect_ratio=1.0,
                              samples_per_pixel=1, max_depth=3, integrator=argv[-1])
    np.testing.assert_array_equal(img, render(loaded.scene, cfg, seed=0).rgb8())


def test_cli_cuda_unavailable_says_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cuda default is valid here")
    rc = cli.main(["--integrator", "pt", "--size", "4x4", "--spp", "1"])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err
