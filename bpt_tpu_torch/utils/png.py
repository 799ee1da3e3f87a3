"""PNG output (replaces libpng, src/image/wpng.h:38-88).

Writes into an auto-created ``output/`` directory like the reference unless
the filename is absolute or ``output_dir`` overrides it.  Uses a dependency-
free zlib encoder so PNG writing never hinges on Pillow.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgb8: np.ndarray) -> bytes:
    """rgb8: uint8 [H,W,3] -> PNG bytes (8-bit RGB, no interlace)."""
    rgb8 = np.ascontiguousarray(np.asarray(rgb8, dtype=np.uint8))
    h, w, c = rgb8.shape
    assert c == 3
    raw = b"".join(b"\x00" + rgb8[j].tobytes() for j in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(filename: str, rgb8: np.ndarray, output_dir: str = "output") -> str:
    """Write PNG; relative names land in ``output_dir`` (wpng.h:45-49).
    Returns the path written."""
    if os.path.isabs(filename):
        path = filename
    else:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, filename)
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))
    return path


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB(A) PNG to uint8 [H,W,3] (golden-image tests)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
