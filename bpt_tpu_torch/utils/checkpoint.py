"""Checkpoint/resume for long renders.

The reference loses everything on interruption (framebuffer only lives in
memory, src/camera.h:55,139-142).  Here the accumulated sample sum + a
progress counter + seed snapshot to an .npz after each completed unit;
resume reloads and continues the running sum.

Two unit kinds exist (the format is ``bpt_tpu``'s):
  - "stratum": one sample stratum over all pixels (``bpt_tpu``'s jnp and
               pt_wave paths; this port does not resume them yet)
  - "chunk":   one pixel chunk with ALL spp strata fused in-kernel
               (the fused megakernel path, the one this port renders)
A checkpoint written by one loop shape resumes only on the same shape.
"""

from __future__ import annotations

import os

import numpy as np


def save_checkpoint(path: str, state: dict) -> None:
    tmp = path + ".tmp"
    units = state.get("units_done", state.get("strata_done", 0))
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            framebuffer_sum=state["framebuffer_sum"],
            strata_done=np.int64(units),
            unit_kind=np.str_(state.get("unit_kind", "stratum")),
            seed=np.int64(state.get("seed", 0)),
            # chunk-kind checkpoints record the chunk size that wrote them:
            # resuming with a different size would mis-place pixel chunks
            chunk_size=np.int64(state.get("chunk_size", 0)),
            # stratum-kind checkpoints record which RNG stream wrote them
            # ("wave" = fused-parity jitter, "jnp" = the bottom wavefront):
            # mixing streams across strata breaks bitwise-identical resume
            stream=np.str_(state.get("stream", "")),
        )
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        kind = str(z["unit_kind"]) if "unit_kind" in z.files else "stratum"
        units = int(z["strata_done"])
        return dict(
            framebuffer_sum=z["framebuffer_sum"],
            strata_done=units,
            units_done=units,
            unit_kind=kind,
            seed=int(z["seed"]),
            chunk_size=int(z["chunk_size"]) if "chunk_size" in z.files else 0,
            stream=str(z["stream"]) if "stream" in z.files else "",
        )
