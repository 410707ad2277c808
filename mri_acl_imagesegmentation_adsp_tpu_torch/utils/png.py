"""PNG writer for 8-bit grayscale and RGB arrays, from ``zlib`` and
``struct`` alone: the port writes its sample grids and preview slices with
it and needs no imaging library."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write ``(H, W)`` gray or ``(H, W, 3)`` RGB uint8 as a PNG file."""
    a = np.ascontiguousarray(arr)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError("write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{a.shape} {a.dtype}")
    h, w = a.shape[:2]
    color = 0 if a.ndim == 2 else 2
    rows = a.reshape(h, -1)
    # filter type 0 (none) in front of every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
