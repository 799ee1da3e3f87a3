"""Brute-force closest and any hit of small scenes: wrappers and plain
versions.

Counterpart of ``bpt_tpu/ops/pallas/intersect.py`` (``closest_pallas``,
``any_pallas``), which ``bpt_tpu``'s dispatch (``ops/soa.py:575-585,
638-644``) runs for every closest hit and shadow ray of a scene without a
BVH on a TPU.  Here ``ops.soa.closest_hit`` / ``any_hit`` launch
``closest_tri`` / ``any_tri`` (``csrc/intersect.cu``) for such a scene on
the card, in float32 or float64.  Unlike the BVH kernels they take any
per-lane interval [tmin, tmax]: BDPT's ref_vis shadow rays end at the
connection's endpoint itself.

Dispatch is by device: a CPU tensor takes the plain version
(``ops.soa.brute_closest`` / ``brute_any``); a CUDA tensor launches the
kernel or raises.  A launch runs on a persistent grid, the blocks the card
holds at once (``bpt_tri_blocks``, the C occupancy query) or as few as its
lanes fill, with a zeroed 64-bit work counter of its own; a call over no
lane launches nothing.  The triangle table is packed once a scene
(``tri_table``).  The wrappers count their launches in
``<wrapper>.launches``, the plain versions their calls in
``<plain>.calls``.  The hit counters (triangle tests, accepted tests) are
the caller's: ``ops.soa.closest_hit`` computes them from the lanes.
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops import soa
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels.pt_kernel import _checked, _device_of, walk_grid
from bpt_tpu_torch.scene.types import SceneTensors, per_scene

DTYPES = (torch.float32, torch.float64)
MAX_TRIS = 256  # the table staged in shared memory (csrc/intersect.cu: TRI_TILE)


def closest_tri_plain(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Plain version of ``closest_tri``."""
    closest_tri_plain.calls += 1
    h = soa.brute_closest(scene, o, d, tmin, tmax)
    return (h.t, torch.where(h.hit, h.tri, -1).to(torch.int32),
            torch.where(h.hit, h.u, 0.0), torch.where(h.hit, h.v, 0.0))


closest_tri_plain.calls = 0


def any_tri_plain(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Plain version of ``any_tri``."""
    any_tri_plain.calls += 1
    return soa.brute_any(scene, o, d, tmin, tmax)


any_tri_plain.calls = 0


@per_scene
def tri_table(scene: SceneTensors) -> torch.Tensor:
    """[T, 9] (v0, e1, e2) of every triangle, in the scene's dtype.  Packed
    once a scene and kept while the scene lives, since every hit call of a
    wave reads it."""
    return torch.cat([scene.v0, scene.e1, scene.e2], dim=1).contiguous()


def _lanes(what, scene, o: Vec3, d: Vec3, tmin, tmax):
    """Checks what a launch takes: (device, B, the six ray components,
    tmin, tmax), each a contiguous [B] tensor of the scene's dtype on its
    device."""
    dev = _device_of(tmax)
    if scene.dtype not in DTYPES:
        raise ValueError(f"{what} takes float32 or float64 scenes, not {scene.dtype}")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device} but lanes on {dev}")
    B = int(tmax.shape[0]) if tmax.dim() == 1 else -1
    ins = [_checked(x, (B,), dev, f"{what} lane input", scene.dtype)
           for x in (*o, *d, tmin, tmax)]
    return dev, B, ins


def _launch(which: str, scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Launches ``which`` (closest_tri or any_tri) over the lanes on its
    persistent grid, with a zeroed work counter of its own; nothing at B =
    0.  Returns its outputs."""
    dev, B, ins = _lanes(which, scene, o, d, tmin, tmax)
    f64 = int(scene.dtype == torch.float64)
    if which == "closest_tri":
        outs = tuple(torch.empty(B, dtype=dt, device=dev)
                     for dt in (scene.dtype, torch.int32, scene.dtype, scene.dtype))
    else:
        outs = (torch.empty(B, dtype=torch.bool, device=dev),)
    if B == 0:
        return outs
    T = scene.num_tris
    if not 1 <= T <= MAX_TRIS:
        raise ValueError(f"{which} takes 1 to {MAX_TRIS} triangles, not {T}: a larger "
                         "scene has a BVH")
    table = tri_table(scene)
    nxt = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        grid = walk_grid(lambda: lib.bpt_tri_blocks(f64, int(which == "any_tri")), B)
        code = getattr(lib, f"bpt_{which}")(
            f64, B, T, grid, table.data_ptr(), *(x.data_ptr() for x in ins),
            *(x.data_ptr() for x in outs), nxt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, which)
    (closest_tri if which == "closest_tri" else any_tri).launches += 1
    return outs


def closest_tri(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Closest hit of each ray over every triangle within its own [tmin,
    tmax] ([B] each); an exact t tie keeps the lower triangle index.
    Returns (t [B], inf on a miss; tri [B] int32, -1 on a miss; u, v [B],
    0 on a miss), in the scene's dtype."""
    if _device_of(tmax).type == "cpu":
        return closest_tri_plain(scene, o, d, tmin, tmax)
    return _launch("closest_tri", scene, o, d, tmin, tmax)


closest_tri.launches = 0


def any_tri(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Whether each ray hits any triangle within its own [tmin, tmax] ([B]
    each; a lane with tmax < tmin hits nothing).  Returns hit [B] bool."""
    if _device_of(tmax).type == "cpu":
        return any_tri_plain(scene, o, d, tmin, tmax)
    return _launch("any_tri", scene, o, d, tmin, tmax)[0]


any_tri.launches = 0
