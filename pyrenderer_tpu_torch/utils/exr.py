"""Minimal OpenEXR scanline I/O in pure Python (no external EXR backend).

Counterpart of pyrenderer_tpu/utils/exr.py:

  write: single-part scanline, 3 x FLOAT (B, G, R) channels, ZIP
         compression (zlib + the EXR delta/deinterleave predictor,
         16-scanline blocks) or none;
  read:  single-part scanline images with NO_COMPRESSION, ZIPS, ZIP or
         PIZ (utils/exr_piz.py), HALF or FLOAT channels.

Format reference: the public OpenEXR file layout documentation
(openexr.com/en/latest/OpenEXRFileLayout.html). Everything here is
little-endian; channel lists are stored alphabetically as EXR requires.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from pyrenderer_tpu_torch.utils.exr_piz import piz_uncompress

_MAGIC = 20000630
_VERSION = 2

# compression enum values
_NO_COMPRESSION = 0
_ZIPS_COMPRESSION = 2   # zlib, 1 scanline per block
_ZIP_COMPRESSION = 3    # zlib, 16 scanlines per block
_PIZ_COMPRESSION = 4    # wavelet + Huffman, 32 scanlines per block (decode only)

_PIXEL_HALF = 1
_PIXEL_FLOAT = 2

_BLOCK_LINES = {_NO_COMPRESSION: 1, _ZIPS_COMPRESSION: 1, _ZIP_COMPRESSION: 16,
                _PIZ_COMPRESSION: 32}


def _attr(name: bytes, typ: bytes, value: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(value)) + value


def _chan(name: bytes, pixel_type: int) -> bytes:
    #  name \0 pixelType pLinear reserved[3] xSampling ySampling
    return name + b"\x00" + struct.pack("<iBBBBii", pixel_type, 0, 0, 0, 0, 1, 1)


def _predictor_encode(raw: bytes) -> bytes:
    """EXR 'ZIP' pre-filter: split odd/even bytes, then delta-encode."""
    a = np.frombuffer(raw, np.uint8)
    half = (len(a) + 1) // 2
    inter = np.empty_like(a)
    inter[:half] = a[0::2]
    inter[half:] = a[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + (-128 + 256)
    return d.astype(np.uint8).tobytes()


def _predictor_decode(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8).astype(np.uint8).copy()
    # undo delta
    d = a.astype(np.int64)
    d[1:] -= 128 + 256
    d = np.cumsum(d) % 256
    a = d.astype(np.uint8)
    # undo interleave split
    half = (len(a) + 1) // 2
    out = np.empty_like(a)
    out[0::2] = a[:half]
    out[1::2] = a[half:]
    return out.tobytes()


def write_exr(path: str, img: np.ndarray, compression: str = "zip") -> str:
    """img: (H, W, 3) float RGB -> scanline EXR (FLOAT channels)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    comp = {"none": _NO_COMPRESSION, "zip": _ZIP_COMPRESSION}[compression]
    lines_per_block = _BLOCK_LINES[comp]

    channels = _chan(b"B", _PIXEL_FLOAT) + _chan(b"G", _PIXEL_FLOAT) + \
        _chan(b"R", _PIXEL_FLOAT) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr(b"channels", b"chlist", channels),
        _attr(b"compression", b"compression", struct.pack("<B", comp)),
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", b"\x00"),          # increasing y
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\x00",
    ])

    blocks = []
    for y0 in range(0, h, lines_per_block):
        rows = img[y0:y0 + lines_per_block]
        # per scanline: channels alphabetically (B, G, R), planar
        raw = b"".join(
            np.ascontiguousarray(rows[i, :, c]).tobytes()
            for i in range(rows.shape[0]) for c in (2, 1, 0)
        )
        if comp == _NO_COMPRESSION:
            data = raw
        else:
            data = zlib.compress(_predictor_encode(raw))
            if len(data) >= len(raw):
                data = raw                      # EXR stores raw if bigger
        blocks.append((y0, data))

    preamble = struct.pack("<ii", _MAGIC, _VERSION) + header
    table_pos = len(preamble)
    data_pos = table_pos + 8 * len(blocks)
    offsets = []
    cursor = data_pos
    for _, data in blocks:
        offsets.append(cursor)
        cursor += 8 + len(data)
    with open(path, "wb") as fh:
        fh.write(preamble)
        for off in offsets:
            fh.write(struct.pack("<Q", off))
        for y0, data in blocks:
            fh.write(struct.pack("<ii", y0, len(data)))
            fh.write(data)
    return path


def _read_attrs(buf: bytes, pos: int):
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\x00", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\x00", pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path: str) -> np.ndarray:
    """Single-part scanline EXR -> (H, W, C) float32 (RGB order when the
    channels are B/G/R; otherwise channel-alphabetical order)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    attrs, pos = _read_attrs(buf, 8)

    # channels: name \0 pixelType(i32) pLinear(u8) reserved(3) xSamp(i32) ySamp(i32)
    chl = attrs["channels"][1]
    chans = []
    p = 0
    while chl[p] != 0:
        e = chl.index(b"\x00", p)
        name = chl[p:e].decode()
        ptype, = struct.unpack_from("<i", chl, e + 1)
        xs_, ys_ = struct.unpack_from("<ii", chl, e + 9)
        if ptype not in (_PIXEL_HALF, _PIXEL_FLOAT):
            raise NotImplementedError(
                f"EXR channel {name!r}: pixel type {ptype} (UINT?) not supported"
            )
        if xs_ != 1 or ys_ != 1:
            raise NotImplementedError(
                f"EXR channel {name!r}: subsampling {xs_}x{ys_} not supported"
            )
        chans.append((name, ptype))
        p = e + 1 + 16
    comp = attrs["compression"][1][0]
    if comp not in _BLOCK_LINES:
        raise NotImplementedError(f"EXR compression {comp} not supported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines_per_block = _BLOCK_LINES[comp]
    n_blocks = (h + lines_per_block - 1) // lines_per_block

    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)
    out = np.empty((h, w, len(chans)), np.float32)
    dtypes = {_PIXEL_HALF: np.float16, _PIXEL_FLOAT: np.float32}
    line_bytes = sum(w * np.dtype(dtypes[t]).itemsize for _, t in chans)
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8: off + 8 + size]
        rows = min(lines_per_block, y1 - y + 1)
        raw_len = rows * line_bytes
        if comp == _PIZ_COMPRESSION and size != raw_len:
            data = piz_uncompress(data, chans, w, rows)
        elif comp != _NO_COMPRESSION and size != raw_len:
            data = _predictor_decode(zlib.decompress(data))
        p = 0
        for i in range(rows):
            for c, (_, ptype) in enumerate(chans):
                dt = dtypes[ptype]
                nbytes = w * np.dtype(dt).itemsize
                out[y - y0 + i, :, c] = np.frombuffer(
                    data, dt, w, offset=p).astype(np.float32)
                p += nbytes
    # channels are stored alphabetically; reorder to R, G, B (+ the rest,
    # e.g. A) whenever those names are present, so BGR and RGBA files both
    # come out RGB-first instead of silently channel-swapped
    names = [n for n, _ in chans]
    if {"R", "G", "B"} <= set(names):
        rest = [i for i, n in enumerate(names) if n not in ("R", "G", "B")]
        order = [names.index("R"), names.index("G"), names.index("B")] + rest
        out = out[:, :, order]
    return np.ascontiguousarray(out)
