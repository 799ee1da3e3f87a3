"""Orthonormal basis from a normal, batched (src/acceleration/onb.h:4-24):
w = unit(n), helper axis (0,1,0) when |w.x| > 0.9 else (1,0,0),
v = unit(w x a), u = w x v."""

from __future__ import annotations

import torch

from bpt_tpu_torch.core import vecmath as vm


def onb_from_w(n):
    """Return (u, v, w) each shaped like ``n`` ([..., 3])."""
    w = vm.unit_vector(n)
    pick = (torch.abs(w[..., 0]) > 0.9)[..., None]
    a = torch.where(
        pick,
        torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device),
        torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device),
    )
    v = vm.unit_vector(vm.cross(w, a))
    u = vm.cross(w, v)
    return u, v, w


def onb_transform(u, v, w, local):
    """Basis coords -> world (src/acceleration/onb.h:16-19)."""
    return local[..., 0:1] * u + local[..., 1:2] * v + local[..., 2:3] * w
