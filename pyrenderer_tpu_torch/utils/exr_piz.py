"""PIZ (wavelet + Huffman) decoding for the minimal EXR reader
(utils/exr.py). NumPy only; the port's own copy of
pyrenderer_tpu/utils/exr_piz.py.

PIZ is the OpenEXR default for renders (Tungsten's ground truth,
media/cornell-box/TungstenRender.exr, is one). The algorithm follows the
public OpenEXR file-layout spec (ImfPizCompressor / ImfHuf / ImfWav):

  block = [minNonZero u16][maxNonZero u16][bitmap bytes]
          [length i32][huffman-packed data]
  1. bitmap -> reverse LUT (the sorted set of u16 values that occur);
  2. canonical-Huffman decode (6-bit code-length table with zero-run
     codes, MSB-first bitstream, RLE marker symbol = iM) into u16 planes;
  3. per channel plane: inverse 2D integer Haar wavelet (wdec14, or
     wdec16 mod-2^16 arithmetic when the value range needs it);
  4. apply the LUT, then emit scanline-interleaved channel rows.

Decode only: utils/exr.py writes ZIP, which every EXR consumer reads.
"""

from __future__ import annotations

import struct

import numpy as np

_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6


class _BitReader:
    """MSB-first bit reader over a bytes buffer (OpenEXR getBits)."""

    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(br: _BitReader, im: int, iM: int) -> np.ndarray:
    """Per-symbol code lengths (0 = absent), zero-run codes expanded."""
    lens = np.zeros(65537, np.int32)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == _LONG_ZEROCODE_RUN:
            i += br.get(8) + _SHORTEST_LONG_RUN
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lens[i] = l
            i += 1
    return lens


def _canonical_codes(lens: np.ndarray):
    """OpenEXR canonical code assignment: per-length bases computed from
    the longest length down, codes handed out in symbol order."""
    n = np.zeros(60, np.int64)
    for l in lens[lens > 0]:
        n[l] += 1
    c = 0
    for l in range(58, 0, -1):
        nc = (c + n[l]) >> 1
        n[l] = c
        c = nc
    codes = np.zeros(len(lens), np.int64)
    syms = np.nonzero(lens > 0)[0]
    nxt = n
    for s in syms:
        l = lens[s]
        codes[s] = nxt[l]
        nxt[l] += 1
    return codes, syms


def _huf_decode(data: bytes, n_out: int) -> np.ndarray:
    """hufUncompress: 20-byte header, packed code-length table (flushed to
    a byte boundary), then the nBits-long code stream."""
    im, iM, _table_len, n_bits, _ = struct.unpack_from("<IIIII", data, 0)
    br = _BitReader(data[20:])
    lens = _unpack_enc_table(br, im, iM)
    codes, syms = _canonical_codes(lens)

    # fast path: one table lookup for codes of length <= 12
    fast_bits = 12
    fast = np.full(1 << fast_bits, -1, np.int64)       # packed sym<<8 | len
    long_map = {}
    for s in syms:
        l = int(lens[s])
        code = int(codes[s])
        if l <= fast_bits:
            base = code << (fast_bits - l)
            fast[base:base + (1 << (fast_bits - l))] = (int(s) << 8) | l
        else:
            long_map[(l, code)] = int(s)

    out = np.empty(n_out, np.uint16)
    oi = 0
    rlc = iM
    # the code-length table is flushed to a byte boundary: restart the bit
    # accumulator at the next whole byte
    c = 0
    lc = 0
    pos = br.pos
    data2 = br.data
    nd = len(data2)
    while oi < n_out:
        while lc < fast_bits and pos < nd:
            c = (c << 8) | data2[pos]
            pos += 1
            lc += 8
        if lc >= fast_bits:
            peek = (c >> (lc - fast_bits)) & ((1 << fast_bits) - 1)
        else:
            peek = (c << (fast_bits - lc)) & ((1 << fast_bits) - 1)
        entry = fast[peek]
        if entry >= 0:
            l = int(entry) & 0xFF
            s = int(entry) >> 8
            if lc < l:
                raise ValueError("huffman stream underrun")
        else:
            while lc < 58 and pos < nd:
                c = (c << 8) | data2[pos]
                pos += 1
                lc += 8
            l = fast_bits
            while True:
                l += 1
                if l > 58 or lc < l:
                    raise ValueError("bad huffman code")
                code = (c >> (lc - l)) & ((1 << l) - 1)
                s = long_map.get((l, code))
                if s is not None:
                    break
        lc -= l
        if s == rlc:
            while lc < 8 and pos < nd:
                c = (c << 8) | data2[pos]
                pos += 1
                lc += 8
            run = (c >> (lc - 8)) & 0xFF
            lc -= 8
            if oi == 0:
                raise ValueError("RLE with no previous symbol")
            out[oi:oi + run] = out[oi - 1]
            oi += run
        else:
            out[oi] = s
            oi += 1
    return out


def _wdec14(l, h):
    """Inverse of OpenEXR wdec14: int16 views, arithmetic shifts."""
    ls = l.astype(np.int32)
    ls = np.where(ls > 32767, ls - 65536, ls)
    hs = h.astype(np.int32)
    hs = np.where(hs > 32767, hs - 65536, hs)
    ai = ls + (hs & 1) + (hs >> 1)
    return (ai & 0xFFFF).astype(np.uint16), ((ai - hs) & 0xFFFF).astype(np.uint16)


_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(flat: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                 mx: int) -> None:
    """In-place inverse 2D integer wavelet over a strided u16 plane
    (OpenEXR wav2Decode: levels from coarsest down, 2x2 blocks plus 1D
    leftovers on odd extents). `flat` may be a shifted view (FLOAT
    channels decode their two interleaved u16 streams separately)."""
    wdec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        xs = np.arange(0, nx - p2 + 1, p2)
        ys = np.arange(0, ny - p2 + 1, p2)
        base = ys[:, None] * oy + xs[None, :] * ox
        i01 = base + ox * p
        i10 = base + oy * p
        i11 = i10 + ox * p
        t00, t10 = wdec(flat[base], flat[i10])
        t01, t11 = wdec(flat[i01], flat[i11])
        r00, r01 = wdec(t00, t01)
        r10, r11 = wdec(t10, t11)
        flat[base] = r00
        flat[i01] = r01
        flat[i10] = r10
        flat[i11] = r11
        if nx & p:
            # leftover column at the position the 2x2 sweep stopped
            x = xs[-1] + p2
            idx0 = ys * oy + x * ox
            idx1 = idx0 + oy * p
            a, b = wdec(flat[idx0], flat[idx1])
            flat[idx0] = a
            flat[idx1] = b
        if ny & p:
            y = ys[-1] + p2
            idx0 = y * oy + xs * ox
            idx1 = idx0 + ox * p
            a, b = wdec(flat[idx0], flat[idx1])
            flat[idx0] = a
            flat[idx1] = b
        p2 = p
        p >>= 1


def piz_uncompress(data: bytes, channels, width: int, n_lines: int) -> bytes:
    """One PIZ block -> raw scanline-interleaved bytes (little-endian).

    channels: list of (name, pixel_type) with 1=HALF, 2=FLOAT (pixel-type
    codes as in utils/exr.py); width/n_lines describe this block.
    """
    min_nz, max_nz = struct.unpack_from("<HH", data, 0)
    pos = 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(data, np.uint8, nb, pos)
        pos += nb
    (length,) = struct.unpack_from("<i", data, pos)
    pos += 4

    # reverse LUT: the u16 value of each packed index (0 always present)
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = np.nonzero(bits)[0].astype(np.uint16)
    # reverseLutFromBitmap returns the max packed INDEX (count - 1), which
    # is what selects wdec14 vs wdec16 — not the max u16 value
    max_value = len(lut) - 1

    sizes = [2 if t == 2 else 1 for _, t in channels]   # FLOAT = 2 u16
    counts = [width * s * n_lines for s in sizes]
    total = sum(counts)
    decoded = _huf_decode(data[pos:pos + length], total)

    off = 0
    for (_, _t), s, cnt in zip(channels, sizes, counts):
        plane = decoded[off:off + cnt]
        for j in range(s):
            _wav2_decode(plane[j:], width, s, n_lines, width * s, max_value)
        off += cnt
    mapped = lut[np.minimum(decoded, len(lut) - 1)]

    # emit scanline-interleaved rows: per line, each channel's row
    out = bytearray()
    offs = np.cumsum([0] + counts)
    for y in range(n_lines):
        for ci, s in enumerate(sizes):
            row_w = width * s
            start = offs[ci] + y * row_w
            out += mapped[start:start + row_w].astype("<u2").tobytes()
    return bytes(out)
