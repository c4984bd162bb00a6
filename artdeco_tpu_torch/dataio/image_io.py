"""Image decoding for the datasets, without OpenCV or PIL.

``load_image`` decodes a JPEG or PNG file into (H, W, 3) uint8 RGB, the
byte order of the JAX package's ``cv2.imread`` + ``COLOR_BGR2RGB``.  Where
the native loader can be built (``runtime.native_loader``), libjpeg and
libpng decode it.  Where it cannot (no ``g++`` or no codec headers), PNG is
decoded by ``read_png`` (numpy and zlib, the inverse of
``mapper.scene_io.write_png``), and a JPEG raises with the compiler's
reason.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from artdeco_tpu_torch.runtime import native_loader

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            rec = cur
        elif ftype == 1:     # Sub: a running sum per byte of the pixel
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:     # Up
            rec = (cur + prior) & 255
        elif ftype in (3, 4):
            rec = cur.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    p = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                rec[i] = (rec[i] + p) & 255
            rec = np.asarray(rec, np.int64)
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = rec
        prior = rec
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a non-interlaced PNG of 8 or 16 bits per
    sample (gray, RGB, palette, with or without alpha).  16-bit samples
    keep their high byte and alpha is dropped, as the native decoder does."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise NotImplementedError(f"{path}: PNG of {depth} bits per sample, color type {ctype}")
    bpp = channels * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    px = px.reshape(h, w, channels, depth // 8)[..., 0]     # the high byte
    if ctype == 3:
        return palette[px[..., 0]]
    if channels <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the JPEG or PNG file at ``path``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if native_loader.native_available():
        return native_loader.decode_image(path)
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == PNG_MAGIC:
        return read_png(path)
    raise RuntimeError(f"{path}: decoding a JPEG needs the native loader, which cannot be "
                       f"built on this machine: {native_loader.missing_toolchain()}")
