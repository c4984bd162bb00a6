"""Baseline JPEG encoding in numpy, without OpenCV or PIL.

``encode_jpeg`` writes what the JAX package's web viewer gets from
``cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 50])`` (OpenCV 5.0,
which encodes through libjpeg-turbo 3.1): a JFIF 1.01 header at a 1:1
density, the Annex K quantization tables (libjpeg's scaling for quality 50
leaves them as they are), one baseline sequential scan of Y, Cb and Cr at
4:2:0 with the Annex K Huffman tables.
Every integer step is libjpeg's: the fixed-point RGB->YCbCr conversion,
``h2v2_downsample`` with its alternating 1/2 bias, edge replication to
whole blocks and the dummy blocks of the last MCU row and column, the
``islow`` integer DCT and its rounding on quantization, so the bytes are
OpenCV's.  The entropy coding, the bit packing and the 0xFF stuffing are
whole-array numpy operations: a 960x540 frame has about 10^5 symbols.
"""

from __future__ import annotations

import struct

import numpy as np


def _zigzag() -> np.ndarray:
    """libjpeg's ``jpeg_natural_order``: the natural index of each
    zigzag position."""
    cells = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda c: (c[0] + c[1], c[1] if (c[0] + c[1]) % 2 == 0 else c[0]))
    return np.asarray([8 * i + j for i, j in cells], np.int64)


NATURAL_ORDER = _zigzag()

# Annex K tables (natural order)
LUMA_QUANT = np.asarray([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
CHROMA_QUANT = np.full(64, 99, np.int64)
CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _ac_values(head) -> list:
    """An Annex K AC table's symbols: its irregular head, then every other
    (run, size) symbol in increasing order."""
    rest = sorted(set((r << 4) | s for r in range(16) for s in range(1, 11)) - set(head))
    vals = list(head) + rest
    assert len(vals) == 162
    return vals


# (code lengths 1..16, symbols) of the four Annex K Huffman tables
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), list(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), list(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _ac_values([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82]))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _ac_values([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1]))


def _huff_codes(table) -> tuple:
    """(code, length) of every symbol 0..255 (Annex C's code assignment)."""
    bits, vals = table
    code_of = np.zeros(256, np.int64)
    size_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[vals[k]], size_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


# ---------------------------------------------------------------------------
# libjpeg's integer steps
# ---------------------------------------------------------------------------

def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def rgb_to_ycbcr(rgb: np.ndarray) -> tuple:
    """``rgb_ycc_convert``: 16-bit fixed point, Y rounded half up, Cb and
    Cr by 0.5 - 2^-16."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _pad_edge(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])), mode="edge")


def downsample_h2v2(c: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """``h2v2_downsample`` of a full-size plane: rows padded to even and
    columns to 2 * ``out_cols`` by replication, 2x2 sums with the bias
    1, 2, 1, 2, ... along each row, then the rows padded to ``out_rows``
    by replicating the last one (``expand_bottom_edge``)."""
    h = c.shape[0] + c.shape[0] % 2
    c = _pad_edge(c, h, 2 * out_cols)
    s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = 1 + (np.arange(out_cols) % 2)
    return _pad_edge((s + bias) >> 2, out_rows, out_cols)


CONST_BITS, PASS1_BITS = 13, 2
F0_298, F0_390, F0_541, F0_765 = 2446, 3196, 4433, 6270
F0_899, F1_175, F1_501, F1_847 = 7373, 9633, 12299, 15137
F1_961, F2_053, F2_562, F3_072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, first: bool):
    """One pass of ``jpeg_fdct_islow`` along the last axis."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
    else:
        out[0], out[4] = _descale(t10 + t11, PASS1_BITS), _descale(t10 - t11, PASS1_BITS)
    z1 = (t12 + t13) * F0_541
    out[2] = _descale(z1 + t13 * F0_765, n)
    out[6] = _descale(z1 - t12 * F1_847, n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * F1_175
    t4, t5, t6, t7 = t4 * F0_298, t5 * F2_053, t6 * F3_072, t7 * F1_501
    z1, z2 = -z1 * F0_899, -z2 * F2_562
    z3, z4 = -z3 * F1_961 + z5, -z4 * F0_390 + z5
    out[7] = _descale(t4 + z1 + z3, n)
    out[5] = _descale(t5 + z2 + z4, n)
    out[3] = _descale(t6 + z2 + z3, n)
    out[1] = _descale(t7 + z1 + z4, n)
    return np.stack(out, axis=-1)


def fdct_quantize(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(rows, cols) samples, both multiples of 8 -> (rows/8, cols/8, 64)
    quantized coefficients in zigzag order: ``jpeg_fdct_islow`` (outputs
    scaled by 8) and the rounding division by 8 * q of ``quantize``."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    # int32 as libjpeg's: for 8-bit samples no sum leaves 32 bits
    blocks = (plane.astype(np.int32) - 128).reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
    coef = _fdct_1d(_fdct_1d(blocks, True).swapaxes(-1, -2), False).swapaxes(-1, -2)
    coef = coef.reshape(by, bx, 64)[..., NATURAL_ORDER]
    div = 8 * qtable[NATURAL_ORDER]
    mag = (np.abs(coef) + div // 2) // div
    return np.where(coef < 0, -mag, mag)


# ---------------------------------------------------------------------------
# Entropy coding
# ---------------------------------------------------------------------------

def _nbits(v: np.ndarray) -> np.ndarray:
    """The JPEG size category: bits of |v| (0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _value_bits(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The n low bits of v, or of v - 1 for v < 0 (one's complement)."""
    return np.where(v < 0, v - 1, v) & ((np.int64(1) << n) - 1)


def _code_table(luma, chroma) -> tuple:
    """(code, length) of symbol ``s`` of table ``t`` at index 256 t + s."""
    (cl, sl), (cc, sc) = _huff_codes(luma), _huff_codes(chroma)
    return np.concatenate([cl, cc]), np.concatenate([sl, sc])


DC_CODES = _code_table(DC_LUMA, DC_CHROMA)
AC_CODES = _code_table(AC_LUMA, AC_CHROMA)


def entropy_code(blocks: np.ndarray, comp: np.ndarray, tables: np.ndarray) -> bytes:
    """The scan's bytes.  ``blocks`` (B, 64) quantized zigzag coefficients in
    scan order, ``comp`` (B,) each block's component (for the DC
    prediction), ``tables`` (B,) its Huffman table pair (0 luma, 1
    chroma).  Each symbol and its value bits make one (code, length) pair
    of at most 27 bits; the pairs are packed, padded with 1s and stuffed."""
    B = blocks.shape[0]
    dc = blocks[:, 0]
    diff = np.empty(B, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    (dc_code, dc_len), (ac_code, ac_len) = DC_CODES, AC_CODES
    tbase = tables * 256

    # pairs with sort keys that order a block's DC, then each nonzero AC
    # preceded by its ZRLs (16 zeros each), then its EOB
    s = _nbits(diff)
    keys = [np.arange(B) * 1024]
    codes = [(dc_code[tbase + s] << s) | _value_bits(diff, s)]
    lens = [dc_len[tbase + s] + s]

    ac = blocks[:, 1:]
    bi, k = np.nonzero(ac)                      # by block, then position
    v = ac[bi, k]
    prev = np.full_like(k, -1)
    prev[1:] = np.where(bi[1:] == bi[:-1], k[:-1], -1)
    run = k - prev - 1
    size = _nbits(v)
    sym = tbase[bi] + ((run & 15) << 4) + size
    keys.append(bi * 1024 + (k + 1) * 8 + 7)
    codes.append((ac_code[sym] << size) | _value_bits(v, size))
    lens.append(ac_len[sym] + size)
    n_zrl = run >> 4
    if np.any(n_zrl):
        zi = np.repeat(np.arange(len(bi)), n_zrl)
        j = np.arange(len(zi)) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        zsym = tbase[bi[zi]] + 0xF0
        keys.append(bi[zi] * 1024 + (k[zi] + 1) * 8 + j)
        codes.append(ac_code[zsym])
        lens.append(ac_len[zsym])
    last = np.full(B, -1, np.int64)
    last[bi] = k                                # the last nonzero of each block
    eob = np.nonzero(last < 62)[0]
    keys.append(eob * 1024 + 1000)
    codes.append(ac_code[tbase[eob]])
    lens.append(ac_len[tbase[eob]])

    order = np.argsort(np.concatenate(keys), kind="stable")
    code = np.concatenate(codes)[order].astype(np.uint64)
    length = np.concatenate(lens)[order]
    # a pair lies in the two 32-bit words from its first one: place it in a
    # 64-bit window there and add the windows' halves into the words (the
    # pairs' bits are disjoint, so the sums are ORs, exact in float64)
    end = np.cumsum(length)
    start = end - length
    total = int(end[-1])
    n_words = -(-total // 32) + 1
    word = start >> 5
    window = code << (64 - (start & 31) - length).astype(np.uint64)
    words = (np.bincount(word, weights=(window >> np.uint64(32)).astype(np.float64),
                         minlength=n_words)
             + np.bincount(word + 1, weights=(window & np.uint64(0xFFFFFFFF)).astype(np.float64),
                           minlength=n_words))
    n_bytes = -(-total // 8)
    packed = words.astype(np.uint32).astype(">u4").view(np.uint8)[:n_bytes].copy()
    packed[-1] |= (1 << (8 * n_bytes - total)) - 1     # padded with 1s to a byte
    ff = np.nonzero(packed == 0xFF)[0]
    return np.insert(packed, ff + 1, 0).tobytes()


# ---------------------------------------------------------------------------
# The file
# ---------------------------------------------------------------------------

def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dht(cls_id: int, table) -> bytes:
    bits, vals = table
    return _segment(0xC4, bytes([cls_id]) + bytes(bits) + bytes(vals))


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the baseline JPEG file's bytes, those of
    ``cv2.imencode(".jpg", BGR, [cv2.IMWRITE_JPEG_QUALITY, 50])``."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, not {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"encode_jpeg: {w}x{h} is not a JPEG size")
    y, cb, cr = rgb_to_ycbcr(rgb)
    mh, mw = -(-h // 16), -(-w // 16)           # MCUs
    yb_h, yb_w = -(-h // 8), -(-w // 8)         # luma blocks that hold image samples
    qy_blocks = fdct_quantize(_pad_edge(y, 8 * yb_h, 8 * yb_w), LUMA_QUANT)
    qcb = fdct_quantize(downsample_h2v2(cb, 8 * mh, 8 * mw), CHROMA_QUANT)
    qcr = fdct_quantize(downsample_h2v2(cr, 8 * mh, 8 * mw), CHROMA_QUANT)

    # luma on the MCU grid: the dummy blocks past the image (the last MCU
    # column and row) are zero with the DC of the block before them in
    # scan order, so their DC difference is 0
    luma = np.zeros((2 * mh, 2 * mw, 64), np.int64)
    luma[:yb_h, :yb_w] = qy_blocks
    real = np.zeros((2 * mh, 2 * mw), bool)
    real[:yb_h, :yb_w] = True
    # scan order: per MCU, Y00 Y01 Y10 Y11 Cb Cr
    luma = luma.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh * mw, 4, 64)
    real = real.reshape(mh, 2, mw, 2).transpose(0, 2, 1, 3).reshape(mh * mw, 4)
    flat_real = real.reshape(-1)
    idx = np.where(flat_real, np.arange(flat_real.size), 0)
    np.maximum.accumulate(idx, out=idx)
    luma = luma.reshape(-1, 64)
    luma[~flat_real, 0] = luma[idx[~flat_real], 0]
    blocks = np.concatenate([luma.reshape(mh * mw, 4, 64), qcb.reshape(mh * mw, 1, 64),
                             qcr.reshape(mh * mw, 1, 64)], axis=1).reshape(-1, 64)
    comp = np.tile(np.asarray([0, 0, 0, 0, 1, 2]), mh * mw)
    scan = entropy_code(blocks, comp, (comp > 0).astype(np.int64))

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0)),
           _segment(0xDB, bytes([0]) + LUMA_QUANT[NATURAL_ORDER].astype(np.uint8).tobytes()),
           _segment(0xDB, bytes([1]) + CHROMA_QUANT[NATURAL_ORDER].astype(np.uint8).tobytes()),
           _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                    + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
           _dht(0x00, DC_LUMA), _dht(0x10, AC_LUMA), _dht(0x01, DC_CHROMA),
           _dht(0x11, AC_CHROMA),
           _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
           scan, b"\xff\xd9"]
    return b"".join(out)


# start-of-frame markers: baseline, extended, progressive and lossless, with
# Huffman or arithmetic coding (0xC4, 0xC8 and 0xCC are other segments)
SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_size(data: bytes, markers=frozenset({0xC0})) -> tuple:
    """(width, height) from a JPEG's start-of-frame marker; raises if there
    is none of ``markers`` before the scan.  By default only SOF0, the
    baseline frame ``encode_jpeg`` writes, so a progressive or extended JPEG
    raises; pass ``SOF_MARKERS`` to read any frame's size."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI)")
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker in markers:
            if pos + 9 > len(data):
                raise ValueError("JPEG: start-of-frame segment cut short")
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            return w, h
        if marker == 0xDA:
            break
        pos += 2 + length
    raise ValueError("no start-of-frame marker of "
                     f"{sorted(hex(m) for m in markers)} before the scan")
