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
kernel or raises.  The wrappers count their launches in
``<wrapper>.launches``, the plain versions their calls in
``<plain>.calls``.  The hit counters (triangle tests, accepted tests) are
the caller's: ``ops.soa.closest_hit`` computes them from the lanes.
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.core.vec3 import Vec3
from bpt_tpu_torch.ops import soa
from bpt_tpu_torch.ops.kernels import build
from bpt_tpu_torch.ops.kernels.pt_kernel import _checked, _device_of
from bpt_tpu_torch.scene.types import SceneTensors

DTYPES = (torch.float32, torch.float64)


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


def tri_table(scene: SceneTensors) -> torch.Tensor:
    """[T, 9] (v0, e1, e2) of every triangle, in the scene's dtype."""
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


def closest_tri(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Closest hit of each ray over every triangle within its own [tmin,
    tmax] ([B] each); an exact t tie keeps the lower triangle index.
    Returns (t [B], inf on a miss; tri [B] int32, -1 on a miss; u, v [B],
    0 on a miss), in the scene's dtype."""
    if _device_of(tmax).type == "cpu":
        return closest_tri_plain(scene, o, d, tmin, tmax)
    dev, B, ins = _lanes("closest_tri", scene, o, d, tmin, tmax)
    t, u, v = (torch.empty(B, dtype=scene.dtype, device=dev) for _ in range(3))
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    table = tri_table(scene)
    with torch.cuda.device(dev):
        code = build.load_library().bpt_closest_tri(
            int(scene.dtype == torch.float64), B, scene.num_tris, table.data_ptr(),
            *(x.data_ptr() for x in ins), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "closest_tri")
    closest_tri.launches += 1
    return t, tri, u, v


closest_tri.launches = 0


def any_tri(scene: SceneTensors, o: Vec3, d: Vec3, tmin, tmax):
    """Whether each ray hits any triangle within its own [tmin, tmax] ([B]
    each; a lane with tmax < tmin hits nothing).  Returns hit [B] bool."""
    if _device_of(tmax).type == "cpu":
        return any_tri_plain(scene, o, d, tmin, tmax)
    dev, B, ins = _lanes("any_tri", scene, o, d, tmin, tmax)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    table = tri_table(scene)
    with torch.cuda.device(dev):
        code = build.load_library().bpt_any_tri(
            int(scene.dtype == torch.float64), B, scene.num_tris, table.data_ptr(),
            *(x.data_ptr() for x in ins), hit.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "any_tri")
    any_tri.launches += 1
    return hit


any_tri.launches = 0
