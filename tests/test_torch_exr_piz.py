"""The port's PIZ decoder (pyrenderer_tpu_torch/utils/exr_piz.py) and its
use in read_exr, against the JAX package's copy and against the data that
went in.

No PIZ file is in the repository, so the test makes PIZ blocks itself: a
forward 2D integer wavelet and a canonical-Huffman encoder written here
from the OpenEXR compressor's description (ImfPizCompressor, ImfWav's
wenc14/wenc16/wav2Encode, ImfHuf's code table, its packed length table
with zero runs and its run-length symbol), as test code only.
"""

import heapq
import struct

import numpy as np
import pytest

from pyrenderer_tpu.utils import exr as exr_jax
from pyrenderer_tpu.utils import exr_piz as piz_jax
from pyrenderer_tpu_torch.utils import exr, exr_piz

HALF, FLOAT = 1, 2
_SHORT_ZEROCODE_RUN, _LONG_ZEROCODE_RUN = 59, 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN


# -- the forward wavelet (ImfWav.cpp) -------------------------------------

def _wenc14(a, b):
    a_s, b_s = np.int16(np.uint16(a)).item(), np.int16(np.uint16(b)).item()
    return (a_s + b_s) >> 1 & 0xFFFF, (a_s - b_s) & 0xFFFF


def _wenc16(a, b):
    ao = (a + (1 << 15)) & 0xFFFF
    m = (ao + b) >> 1
    d = ao - b
    if d < 0:
        m = (m + (1 << 15)) & 0xFFFF
    return m, d & 0xFFFF


def _wav2_encode(buf, base, nx, ox, ny, oy, mx):
    """wav2Encode over buf[base + y * oy + x * ox] (a list of ints), in place."""
    wenc = _wenc14 if mx < (1 << 14) else _wenc16
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        y = 0
        while y <= ny - p2:
            x = 0
            while x <= nx - p2:
                i00 = base + y * oy + x * ox
                i01, i10 = i00 + ox * p, i00 + oy * p
                i11 = i10 + ox * p
                a00, a01 = wenc(buf[i00], buf[i01])
                a10, a11 = wenc(buf[i10], buf[i11])
                buf[i00], buf[i10] = wenc(a00, a10)
                buf[i01], buf[i11] = wenc(a01, a11)
                x += p2
            if nx & p:
                i00 = base + y * oy + x * ox
                buf[i00], buf[i00 + oy * p] = wenc(buf[i00], buf[i00 + oy * p])
            y += p2
        if ny & p:
            x = 0
            while x <= nx - p2:
                i00 = base + y * oy + x * ox
                buf[i00], buf[i00 + ox * p] = wenc(buf[i00], buf[i00 + ox * p])
                x += p2
        p, p2 = p2, p2 << 1


# -- the Huffman coder (ImfHuf.cpp) ---------------------------------------

class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def flush(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(np.packbits(np.array(bits, np.uint8)).tobytes()) if bits else b""


def _code_lengths(freq):
    """Huffman code lengths of the symbols with freq > 0 ({symbol: length})."""
    heap = [(f, s, (s,)) for s, f in sorted(freq.items())]
    heapq.heapify(heap)
    lengths = dict.fromkeys(freq, 0)
    if len(heap) == 1:
        return {heap[0][1]: 1}
    while len(heap) > 1:
        fa, ka, sa = heapq.heappop(heap)
        fb, kb, sb = heapq.heappop(heap)
        for s in sa + sb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, min(ka, kb), sa + sb))
    return lengths


def _canonical(lengths):
    """hufCanonicalCodeTable: per-length bases from the longest length
    down, codes handed out in symbol order."""
    count = [0] * 59
    for length in lengths.values():
        count[length] += 1
    base, c = [0] * 59, 0
    for length in range(58, 0, -1):
        base[length], c = c, (c + count[length]) >> 1
    codes = {}
    for s in sorted(lengths):
        codes[s] = base[lengths[s]]
        base[lengths[s]] += 1
    return codes


def _huf_compress(symbols, run_threshold=3):
    """hufCompress: the header, the packed length table (zero runs), then
    the code stream; runs of more than `run_threshold` repeats are sent as
    the symbol, the run-length symbol (the largest symbol + 1) and 8 bits
    of count."""
    symbols = [int(s) for s in symbols]
    stream = []
    i = 0
    while i < len(symbols):
        j = i + 1
        while j < len(symbols) and symbols[j] == symbols[i] and j - i <= 255:
            j += 1
        stream.append(("s", symbols[i]))
        if j - i - 1 > run_threshold:
            stream.append(("r", j - i - 1))
        else:
            stream += [("s", symbols[i])] * (j - i - 1)
        i = j
    im, rlc = min(symbols), max(symbols) + 1
    freq = {rlc: 1}
    for kind, v in stream:
        if kind == "s":
            freq[v] = freq.get(v, 0) + 1
        else:
            freq[rlc] += 1
    lengths = _code_lengths(freq)
    assert max(lengths.values()) <= 58
    codes = _canonical(lengths)

    table = _BitWriter()
    s = im
    while s <= rlc:
        if lengths.get(s, 0) == 0:
            run = 0
            while s <= rlc and lengths.get(s, 0) == 0 and run < _LONGEST_LONG_RUN:
                run += 1
                s += 1
            if run >= _SHORTEST_LONG_RUN:
                table.put(_LONG_ZEROCODE_RUN, 6)
                table.put(run - _SHORTEST_LONG_RUN, 8)
            elif run >= 2:
                table.put(_SHORT_ZEROCODE_RUN + run - 2, 6)
            else:
                table.put(0, 6)
            continue
        table.put(lengths[s], 6)
        s += 1
    table_bytes = table.flush()

    data = _BitWriter()
    for kind, v in stream:
        if kind == "s":
            data.put(codes[v], lengths[v])
        else:
            data.put(codes[rlc], lengths[rlc])
            data.put(v, 8)
    n_bits = len(data.bits)
    return struct.pack("<IIIII", im, rlc, len(table_bytes), n_bits, 0) + table_bytes + data.flush()


def piz_compress(raw: bytes, channels, width, n_lines, run_threshold=3) -> bytes:
    """One PIZ block of scanline-interleaved little-endian raw bytes."""
    sizes = [2 if t == FLOAT else 1 for _, t in channels]
    words = np.frombuffer(raw, "<u2").reshape(n_lines, -1)
    planes, col = [], 0
    for s in sizes:   # each channel's rows, stacked: (n_lines, width * s)
        planes.append(words[:, col:col + width * s].reshape(-1))
        col += width * s
    flat = np.concatenate(planes)

    bitmap = np.zeros(8192, np.uint8)
    present = np.unique(flat)
    np.bitwise_or.at(bitmap, present >> 3, (1 << (present & 7)).astype(np.uint8))
    bitmap[0] &= 0xFE                           # zero is never stored
    present_bits = np.unpackbits(bitmap, bitorder="little")
    present_bits[0] = 1
    values = np.nonzero(present_bits)[0]
    lut = np.zeros(1 << 16, np.int64)
    lut[values] = np.arange(len(values))
    max_value = len(values) - 1

    buf = lut[flat].tolist()
    off = 0
    for s in sizes:
        for j in range(s):
            _wav2_encode(buf, off + j, width, s, n_lines, width * s, max_value)
        off += width * s * n_lines

    nz = np.nonzero(bitmap)[0]
    lo, hi = (int(nz[0]), int(nz[-1])) if nz.size else (8191, 0)
    head = struct.pack("<HH", lo, hi) + (bitmap[lo:hi + 1].tobytes() if lo <= hi else b"")
    huf = _huf_compress(buf, run_threshold)
    return head + struct.pack("<i", len(huf)) + huf


# -- blocks and files -----------------------------------------------------

CHANNELS = [("B", HALF), ("G", FLOAT), ("R", HALF)]


def _raw_block(rs, channels, width, n_lines, spread):
    """Scanline-interleaved raw bytes: per line each channel's row, HALF
    values drawn from `spread` u16 codes, FLOATs as float32; lines 4-11
    are constant (the wavelet's details there are runs of zeros, which the
    coder sends as runs). With spread None, one HALF channel of distinct
    codes."""
    if spread is None:
        return rs.permutation(1 << 16)[:width * n_lines].astype("<u2").tobytes()
    rows = []
    for y in range(n_lines):
        band = 4 <= y < 12
        for _, t in channels:
            if t == HALF:
                v = np.full(width, 7) if band else rs.randint(0, spread, width)
                rows.append(v.astype("<u2").tobytes())
            else:
                v = np.full(width, 0.5) if band else rs.rand(width) * 4
                rows.append(v.astype("<f4").tobytes())
    return b"".join(rows)


@pytest.mark.parametrize("width, n_lines, spread", [
    (37, 13, 200),     # odd extents: leftover columns and lines at every level
    (16, 32, 3000),    # a full PIZ block of 32 lines
    (1, 5, 50),        # one column: no 2D level
    (544, 32, None),   # more than 2^14 distinct values: wdec16
])
def test_piz_block_round_trip(width, n_lines, spread):
    """Both packages' piz_uncompress give the same bytes, which are the
    block's raw data."""
    rs = np.random.RandomState(width * 100 + n_lines)
    channels = CHANNELS if spread else [("Y", HALF)]
    raw = _raw_block(rs, channels, width, n_lines, spread)
    block = piz_compress(raw, channels, width, n_lines)
    ours = exr_piz.piz_uncompress(block, channels, width, n_lines)
    assert ours == piz_jax.piz_uncompress(block, channels, width, n_lines)
    assert ours == raw
    if spread is None:
        assert len(np.unique(np.frombuffer(raw, "<u2"))) > 1 << 14


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wavelet_helpers_bit_equal_to_jax(seed):
    """_wdec14, _wdec16 and _wav2_decode bit for bit the JAX package's on
    random u16 planes (odd and even extents, strides 1 and 2, both value
    ranges)."""
    rs = np.random.RandomState(seed)
    a = rs.randint(0, 1 << 16, 4096).astype(np.uint16)
    b = rs.randint(0, 1 << 16, 4096).astype(np.uint16)
    for ours, theirs in ((exr_piz._wdec14, piz_jax._wdec14), (exr_piz._wdec16, piz_jax._wdec16)):
        for x, y in zip(ours(a, b), theirs(a, b)):
            assert x.dtype == y.dtype == np.uint16 and np.array_equal(x, y)
    for nx, ny, ox in ((13, 9, 1), (32, 32, 2), (7, 20, 2)):
        for mx in (1000, 1 << 15):
            plane = rs.randint(0, 1 << 16, nx * ny * ox).astype(np.uint16)
            p1, p2 = plane.copy(), plane.copy()
            for j in range(ox):
                exr_piz._wav2_decode(p1[j:], nx, ox, ny, nx * ox, mx)
                piz_jax._wav2_decode(p2[j:], nx, ox, ny, nx * ox, mx)
            assert np.array_equal(p1, p2) and not np.array_equal(p1, plane)


def _write_piz_exr(path, img_rgb):
    """A PIZ scanline EXR of (H, W, 3) float32 RGB (B, G, R channels)."""
    h, w = img_rgb.shape[:2]
    chans = [("B", FLOAT), ("G", FLOAT), ("R", FLOAT)]
    chlist = b"".join(n.encode() + b"\x00" + struct.pack("<iBBBBii", t, 0, 0, 0, 0, 1, 1)
                      for n, t in chans) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)

    def attr(name, typ, value):
        return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(value)) + value

    header = b"".join([
        attr(b"channels", b"chlist", chlist),
        attr(b"compression", b"compression", b"\x04"),
        attr(b"dataWindow", b"box2i", box), attr(b"displayWindow", b"box2i", box),
        attr(b"lineOrder", b"lineOrder", b"\x00"),
        attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0)),
        attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)), b"\x00"])
    blocks = []
    for y0 in range(0, h, 32):
        rows = img_rgb[y0:y0 + 32]
        raw = b"".join(np.ascontiguousarray(rows[i, :, c], "<f4").tobytes()
                       for i in range(rows.shape[0]) for c in (2, 1, 0))
        blocks.append((y0, piz_compress(raw, chans, w, rows.shape[0])))
    pos = 8 + len(header) + 8 * len(blocks)
    offsets = []
    for _, data in blocks:
        offsets.append(pos)
        pos += 8 + len(data)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<ii", 20000630, 2) + header)
        fh.write(b"".join(struct.pack("<Q", o) for o in offsets))
        for y0, data in blocks:
            fh.write(struct.pack("<ii", y0, len(data)) + data)


def test_read_exr_piz_file(tmp_path):
    """read_exr decodes a PIZ file (32 lines a block, a short last block)
    to the image that went in, as the JAX package's read_exr does."""
    rs = np.random.RandomState(7)
    img = (rs.rand(70, 23, 3) * 3).astype(np.float32)
    img[10:20] = 0.25
    path = str(tmp_path / "piz.exr")
    _write_piz_exr(path, img)
    ours = exr.read_exr(path)
    assert ours.shape == (70, 23, 3) and np.array_equal(ours, img)
    assert np.array_equal(ours, exr_jax.read_exr(path))
