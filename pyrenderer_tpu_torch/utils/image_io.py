"""Image output: PNG (LDR) and EXR/NPY (HDR), standard library and NumPy
only. Counterpart of pyrenderer_tpu/utils/image_io.py, whose PNG writer
needs imageio; this one writes the PNG itself with zlib and struct.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, ldr: np.ndarray) -> None:
    """ldr in [0, 1], (H, W, 3) -> 8-bit RGB PNG (no filtering, zlib level 6)."""
    rgb8 = (np.clip(np.asarray(ldr), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, c = rgb8.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {rgb8.shape}")
    # every scanline starts with its filter type byte, 0 = None
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIGNATURE)
        fh.write(_png_chunk(b"IHDR", ihdr))
        fh.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_png_chunk(b"IEND", b""))


def write_hdr(path: str, hdr: np.ndarray) -> str:
    """Write float radiance: `.exr` through the bundled OpenEXR writer
    (utils/exr.py), anything else as `.npy`. Returns the path written."""
    hdr = np.asarray(hdr, np.float32)
    if path.endswith(".exr"):
        from pyrenderer_tpu_torch.utils.exr import write_exr

        return write_exr(path, hdr)
    if not path.endswith(".npy"):
        path = path + ".npy"
    np.save(path, hdr)
    return path
