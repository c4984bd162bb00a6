"""OpenCV's image resampling, in numpy, without OpenCV.

The JAX package resamples its frames with ``cv2.resize`` (INTER_AREA when
shrinking, INTER_CUBIC when growing) and undistorts them with
``cv2.remap`` (INTER_LINEAR, constant zero border).  The port's hosts have
no OpenCV, so these functions compute what OpenCV computes, in its own
order of float32 operations and with its own fixed-point rounding:

* ``resize_area``: INTER_AREA at a scale of at least 1 on both axes
  (``cv2.resize(img, (dw, dh))``; ``resize_area_scale`` is the
  ``cv2.resize(img, (0, 0), fx=fx, fy=fy)`` form, whose scale is ``1 /
  fx``, not ``w / dw``).  At an integer scale, OpenCV's block average
  (``(sum + 2) >> 2`` at 2x2, else the float32 ``sum * (1 / area)``
  rounded half to even; a block cut by the image's edge averages the
  pixels it holds); at any other scale, its per-axis tables
  (``area_tab``, OpenCV's ``computeResizeAreaTab``) summed in float32, a
  source row at a time.
* ``resize_cubic``: INTER_CUBIC (a = -0.75) on uint8, separable, in
  float64; within one level of OpenCV 5.0 on about 1e-5 of the bytes.
* ``remap_bilinear``: INTER_LINEAR with float32 maps, as OpenCV 5.0's
  float32 kernel computes it, with a constant zero border or
  BORDER_REFLECT.
* ``area_matrix``: INTER_AREA along one axis as a weight matrix, for
  resizing float images on the device (``vslam/accurate_lc.py``).
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def area_tab(n_in: int, n_out: int, scale: float | None = None):
    """OpenCV's ``computeResizeAreaTab`` for shrinking ``n_in`` samples to
    ``n_out`` at ``scale`` source samples a destination sample (by default
    ``1 / (n_out / n_in)``, as ``cv2.resize`` takes it from a destination
    size): (dst, src, alpha float32) arrays, in OpenCV's order (by
    destination, then source)."""
    if scale is None:
        scale = 1.0 / (n_out / n_in)
    dst, src, alpha = [], [], []
    for d in range(n_out):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, n_in - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            dst.append(d), src.append(s1 - 1), alpha.append((s1 - fs1) / cell)
        for s in range(s1, s2):
            dst.append(d), src.append(s), alpha.append(1.0 / cell)
        if fs2 - s2 > 1e-3:
            dst.append(d), src.append(s2), alpha.append(min(min(fs2 - s2, 1.0), cell) / cell)
    return (np.asarray(dst, np.int64), np.asarray(src, np.int64),
            np.asarray(alpha, np.float64).astype(_F32))


def _padded_tab(n_in: int, n_out: int, scale: float):
    """``area_tab`` as (n_out, M) source indices and weights, each row's
    entries in OpenCV's order and padded with zero weights (adding a zero
    product leaves a float32 sum as it is)."""
    dst, src, alpha = area_tab(n_in, n_out, scale)
    counts = np.bincount(dst, minlength=n_out)
    m = int(counts.max())
    idx = np.zeros((n_out, m), np.int64)
    w = np.zeros((n_out, m), _F32)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(dst)) - start[dst]
    idx[dst, col] = src
    w[dst, col] = alpha
    return idx, w


def area_matrix(n_in: int, n_out: int, shrink: bool) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``cv2.resize(INTER_AREA)`` along one
    axis; ``shrink`` when the image shrinks along both axes (OpenCV's area
    tables), else its linear rule with the fraction
    ``(d + 1) - (s + 1) / scale``, ``s = floor(d * scale)``."""
    if shrink:
        w = np.zeros((n_out, n_in), _F32)
        dst, src, alpha = area_tab(n_in, n_out)
        np.add.at(w, (dst, src), alpha)
        return w
    w = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    inv = n_out / n_in
    for d in range(n_out):
        s = int(math.floor(d * scale))
        f = _F32((d + 1) - (s + 1) * inv)
        f = _F32(0.0) if f <= 0 else f - _F32(math.floor(f))
        if s >= n_in - 1:
            s, f = n_in - 1, _F32(0.0)
        w[d, s] += _F32(1.0) - f
        if f:
            w[d, s + 1] += f
    return w.astype(_F32)


def _round_u8(x: np.ndarray) -> np.ndarray:
    """OpenCV's ``saturate_cast<uchar>`` of float32: round half to even,
    then clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _area_fast(img: np.ndarray, kx: int, ky: int, dw: int, dh: int) -> np.ndarray:
    """INTER_AREA at integer scales (OpenCV's ``resizeAreaFast_``).  Where
    the last block of a row or column passes the image's edge (the ``fx``
    form can round the size up), the block averages the pixels it holds,
    in float32 rounded half to even."""
    h, w, c = img.shape
    fw, fh = min(dw, w // kx), min(dh, h // ky)       # whole blocks
    blocks = img[:fh * ky, :fw * kx].reshape(fh, ky, fw, kx, c)
    n = kx * ky
    if img.dtype == np.uint8:
        s = blocks.astype(np.int64).sum(axis=(1, 3))
        if kx == ky == 2:
            full = ((s + 2) >> 2).astype(np.uint8)
        else:
            full = _round_u8(s.astype(_F32) * _F32(1.0 / n))
    else:
        # OpenCV's generic loop: sum += ((a + b) + c) + d over the block,
        # row-major, four at a time
        flat = blocks.astype(_F32).transpose(0, 2, 4, 1, 3).reshape(fh, fw, c, n)
        s = np.zeros((fh, fw, c), _F32)
        k = 0
        while k + 4 <= n:
            s = s + (((flat[..., k] + flat[..., k + 1]) + flat[..., k + 2]) + flat[..., k + 3])
            k += 4
        for k in range(k, n):
            s = s + flat[..., k]
        full = s * _F32(1.0 / n)
    if (fw, fh) == (dw, dh):
        return full
    out = np.zeros((dh, dw, c), img.dtype)
    out[:fh, :fw] = full
    # the cut blocks: float32 sum / count over the pixels they hold, summed
    # row-major as OpenCV does (an integer sum for uint8)
    for y in range(dh):
        for x in range(fw if y < fh else 0, dw):
            px = img[y * ky:(y + 1) * ky, x * kx:(x + 1) * kx].reshape(-1, c)
            if img.dtype == np.uint8:
                out[y, x] = _round_u8(px.astype(np.int64).sum(0).astype(_F32) / _F32(len(px)))
            else:
                total = np.zeros(c, _F32)
                for p in px.astype(_F32):
                    total = total + p
                out[y, x] = total / _F32(len(px))
    return out


def _resize_area(img: np.ndarray, dw: int, dh: int, sx: float, sy: float) -> np.ndarray:
    """INTER_AREA of an (H, W, C) image to (dw, dh) at the scales ``sx``,
    ``sy`` (source pixels a destination pixel, at least 1), as OpenCV's
    ``hal::resize`` takes them."""
    h, w = img.shape[:2]
    if (dw, dh) == (w, h):
        return img.copy()
    if sx < 1 or sy < 1:
        raise NotImplementedError(
            f"INTER_AREA from {w}x{h} to {dw}x{dh}: only shrinking is ported")
    kx, ky = int(round(sx)), int(round(sy))
    if abs(sx - kx) < np.finfo(np.float64).eps and abs(sy - ky) < np.finfo(np.float64).eps:
        return _area_fast(img, kx, ky, dw, dh)
    u8 = img.dtype == np.uint8
    src = img.astype(_F32)
    xi, xw = _padded_tab(w, dw, sx)
    yi, yw = _padded_tab(h, dh, sy)
    # horizontal: buf = (buf + S * alpha), entry by entry, every source row
    buf = np.zeros((h, dw, img.shape[2]), _F32)
    for m in range(xi.shape[1]):
        buf = buf + src[:, xi[:, m], :] * xw[None, :, m, None]
    # vertical: sum = (sum + beta * buf[row]), row by row
    acc = np.zeros((dh, dw, img.shape[2]), _F32)
    for m in range(yi.shape[1]):
        acc = acc + yw[:, m, None, None] * buf[yi[:, m]]
    return _round_u8(acc) if u8 else acc


def resize_area(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)`` of an
    (H, W, C) uint8 or float32 image that shrinks (or keeps) both axes."""
    h, w = img.shape[:2]
    return _resize_area(img, dw, dh, 1.0 / (dw / w), 1.0 / (dh / h))


def resize_area_scale(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy, interpolation=cv2.INTER_AREA)``
    of an (H, W, C) uint8 or float32 image, ``fx, fy <= 1``: the size is
    ``cvRound(w * fx) x cvRound(h * fy)`` (half to even) and the scale
    ``1 / fx`` (``1 / fy``), which differs from ``w / dw`` where the size
    does not divide."""
    h, w = img.shape[:2]
    dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
    if dw <= 0 or dh <= 0:
        raise ValueError(f"INTER_AREA of {w}x{h} by fx {fx}, fy {fy}: an empty image")
    return _resize_area(img, dw, dh, 1.0 / fx, 1.0 / fy)


def _cubic_tab(n_in: int, n_out: int):
    """INTER_CUBIC's taps (clamped to the border) and float64 weights along
    one axis: (n_out, 4) each."""
    scale = 1.0 / (n_out / n_in)
    a = -0.75
    idx = np.zeros((n_out, 4), np.int64)
    wts = np.zeros((n_out, 4), np.float64)
    for d in range(n_out):
        f = (d + 0.5) * scale - 0.5
        s = math.floor(f)
        x = f - s
        c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
        c1 = ((a + 2) * x - (a + 3)) * x * x + 1
        c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
        wts[d] = (c0, c1, c2, 1 - c0 - c1 - c2)
        idx[d] = [min(max(s - 1 + k, 0), n_in - 1) for k in range(4)]
    return idx, wts


def resize_cubic(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``cv2.resize(img, (dw, dh), interpolation=cv2.INTER_CUBIC)`` of an
    (H, W, C) uint8 image, evaluated in float64 and rounded half to even.
    OpenCV 5.0 rounds its own way at near-ties: about 1e-5 of the bytes
    differ from it by one level (``tests/test_torch_camera.py``)."""
    if img.dtype != np.uint8:
        raise NotImplementedError("INTER_CUBIC is ported for uint8 images")
    h, w, _ = img.shape
    if (dw, dh) == (w, h):
        return img.copy()
    xi, xw = _cubic_tab(w, dw)
    yi, yw = _cubic_tab(h, dh)
    src = img.astype(np.float64)
    hor = sum(src[:, xi[:, k], :] * xw[None, :, k, None] for k in range(4))
    out = sum(hor[yi[:, k]] * yw[:, k, None, None] for k in range(4))
    return _round_u8(out)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product is exact in
    float64)."""
    return (a.astype(np.float64) * b + c).astype(_F32)


def _reflect(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's ``borderInterpolate(p, n, BORDER_REFLECT)``
    (``fedcba|abcdefgh|hgfedcb``), repeated until ``p`` is inside."""
    if n == 1:
        return np.zeros_like(p)
    p = np.mod(p, 2 * n)
    return np.where(p < n, p, 2 * n - 1 - p)


def remap_bilinear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray,
                   border: str = "constant") -> np.ndarray:
    """``cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)`` with float32 maps,
    for an (H, W) or (H, W, C) uint8 or float32 image, with a constant zero
    border (``border="constant"``) or ``cv2.BORDER_REFLECT``
    (``"reflect"``, each of the four taps reflected on its own): OpenCV
    5.0's float32 kernel, a fused multiply-add lerp along x on two rows,
    then along y, rounded half to even for uint8."""
    if border not in ("constant", "reflect"):
        raise ValueError(f"remap border {border!r}: 'constant' or 'reflect'")
    if img.ndim == 2:
        return remap_bilinear(img[..., None], mapx, mapy, border)[..., 0]
    h, w = img.shape[:2]
    mx, my = mapx.astype(_F32), mapy.astype(_F32)
    fx, fy = np.floor(mx), np.floor(my)
    ax, ay = (mx - fx)[..., None], (my - fy)[..., None]
    sx, sy = fx.astype(np.int64), fy.astype(np.int64)
    taps = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = sy + dy, sx + dx
        if border == "reflect":
            taps.append(img[_reflect(yy, h), _reflect(xx, w)].astype(_F32))
            continue
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(_F32)
        taps.append(np.where(inside[..., None], v, _F32(0)))
    v00, v01, v10, v11 = taps
    t0 = _fma32(v01 - v00, ax, v00)
    t1 = _fma32(v11 - v10, ax, v10)
    out = _fma32(t1 - t0, ay, t0)
    return _round_u8(out) if img.dtype == np.uint8 else out
