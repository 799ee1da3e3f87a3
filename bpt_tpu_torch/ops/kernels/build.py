"""Build and load the package's CUDA kernels.

``nvcc`` compiles every ``bpt_tpu_torch/csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs on first use and is cached in ``bpt_tpu_torch/build/`` (listed in
``.gitignore``) under a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads in milliseconds.  A failed build
raises; nothing falls back.

Flags: no ``--use_fast_math``, and ``-fmad=false`` so that nvcc does not
contract ``a*b+c`` into one rounding — the kernels then round every
operation as the plain PyTorch versions and the JAX reference do, and the
branch decisions fed by Möller–Trumbore agree with theirs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# bpt_pt_megakernel(pixels, B, T, L, depth, spp_loop, sqrt_spp, N, k0, nk,
#                   grid, tri, nodes, tris, mat_id, mat, lgt, keys, cam,
#                   in0..in5, rid, ubuf, out_r, out_g, out_b, counters, next,
#                   V, VT, vol, volm, stream)
# bpt_bdpt_megakernel(pixels, mis, B, T, L, depth, sqrt_spp, nkeys, N, k0,
#                     nk, grid, tri, nodes, tris, mat_id, mat, lgt, keys, cam,
#                     in0..in5, rid, ubuf, vtx, out_r, out_g, out_b, counters,
#                     next, V, VT, vol, volm, stream)
# bpt_pt_blocks(walk, vols), bpt_bdpt_blocks(walk, vols): the persistent
# megakernels' resident blocks (walk or brute mode, with or without volumes)
# bpt_closest_bvh(B, N, bounds_ok, nodes, tris, ox, oy, oz, dx, dy, dz, active,
#                 t, tri, u, v, counters, stream)
# bpt_any_bvh(B, N, bounds_ok, nodes, tris, ox, oy, oz, dx, dy, dz, tmax, hit,
#             counters, stream)
# bpt_pt_wave_bounce(B, N, L, bounce, nodes, tris, mat_id, mat, lgt, keys,
#                    state_in, rid, hit_t, hit_tri, state_out, counters, V, VT,
#                    vol, volm, stream)
# bpt_closest_bvh_f64(B, N, bounds_ord, nodes, tris, ox, oy, oz, dx, dy, dz, tmin,
#                     tmax, active, t, tri, u, v, counters, stream)
# bpt_any_bvh_f64(B, N, bounds_ord, nodes, tris, ox, oy, oz, dx, dy, dz, tmin, tmax,
#                 hit, counters, stream)
# bpt_wave_blocks(), bpt_any_blocks(): closest_bvh's and any_bvh's persistent grids;
# bpt_bvh_f64_blocks(any): those of their float64 instantiations
# bpt_strata_sum(first, B, nk, rows, tot, stream)
# bpt_closest_tri(f64, B, T, grid, tri, ox, oy, oz, dx, dy, dz, tmin, tmax,
#                 t, tri_out, u, v, next, stream)
# bpt_any_tri(f64, B, T, grid, tri, ox, oy, oz, dx, dy, dz, tmin, tmax, hit,
#             next, stream)
# bpt_tri_blocks(f64, any): closest_tri's or any_tri's persistent grid
# bpt_clustered_hit(any, B, S, C, T, table, blocks, ox, oy, oz, dx, dy, dz,
#                   tmin, tmax, t, tri, u, v, hit, counters, sched, stream)
# bpt_plucker_hit: the same arguments (S: the closest hit's chop groups)
# bpt_clustered_blocks(), bpt_plucker_blocks(), bpt_clustered_any_blocks(),
# bpt_plucker_any_blocks(): the clustered hits' persistent grids
_SIGNATURES = {
    "bpt_pt_megakernel": ([_I] * 11 + [_P] * 8 + [_P] * 6 + [_P] * 2
                          + [_P] * 4 + [_P] + [_I] * 2 + [_P] * 2 + [_P], _I),
    "bpt_bdpt_megakernel": ([_I] * 12 + [_P] * 8 + [_P] * 6 + [_P] * 3
                            + [_P] * 4 + [_P] + [_I] * 2 + [_P] * 2 + [_P], _I),
    "bpt_pt_blocks": ([_I] * 2, _I),
    "bpt_bdpt_blocks": ([_I] * 2, _I),
    "bpt_closest_bvh": ([_I] * 3 + [_P] * 2 + [_P] * 7 + [_P] * 4 + [_P] * 2, _I),
    "bpt_any_bvh": ([_I] * 3 + [_P] * 2 + [_P] * 7 + [_P] * 2 + [_P], _I),
    "bpt_pt_wave_bounce": ([_I] * 4 + [_P] * 6 + [_P] * 5 + [_P] + [_I] * 2 + [_P] * 3,
                           _I),
    "bpt_closest_bvh_f64": ([_I] * 3 + [_P] * 2 + [_P] * 6 + [_P] * 3 + [_P] * 4
                            + [_P] * 2, _I),
    "bpt_any_bvh_f64": ([_I] * 3 + [_P] * 2 + [_P] * 6 + [_P] * 2 + [_P] * 2 + [_P], _I),
    "bpt_wave_blocks": ([], _I),
    "bpt_bvh_f64_blocks": ([_I], _I),
    "bpt_any_blocks": ([], _I),
    "bpt_strata_sum": ([_I] * 3 + [_P] * 2 + [_P], _I),
    "bpt_closest_tri": ([_I] * 4 + [_P] + [_P] * 8 + [_P] * 4 + [_P] * 2, _I),
    "bpt_any_tri": ([_I] * 4 + [_P] + [_P] * 8 + [_P] + [_P] * 2, _I),
    "bpt_tri_blocks": ([_I] * 2, _I),
    "bpt_clustered_hit": ([_I] * 5 + [_P] * 2 + [_P] * 8 + [_P] * 5 + [_P] * 3, _I),
    "bpt_plucker_hit": ([_I] * 5 + [_P] * 2 + [_P] * 8 + [_P] * 5 + [_P] * 3, _I),
    "bpt_clustered_blocks": ([], _I),
    "bpt_plucker_blocks": ([], _I),
    "bpt_clustered_any_blocks": ([], _I),
    "bpt_plucker_any_blocks": ([], _I),
    "bpt_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of bpt_tpu_torch "
                           "build only where the CUDA toolkit is installed")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libbpt_tpu_torch_{_source_hash()}.so"


def build() -> Path:
    """Compile the kernels if the cached library is missing; returns it.
    nvcc's output (the ptxas register/spill report) goes beside it, in
    ``library_path().with_suffix(".log")``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(sources, procs)]
    log = "".join(logs)
    if any(proc.returncode != 0 for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with every entry
    point's argtypes and restype declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = load_library().bpt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
