"""Pinhole camera with dual SLAM/map resolutions and lens undistortion.

Port of ``artdeco_tpu/dataio/camera.py`` in numpy, without OpenCV: what
the JAX package asks of ``cv2`` is computed here as OpenCV 5.0 computes it.

* intrinsics: ``cv2.getOptimalNewCameraMatrix(K, dist, (W, H), alpha=0,
  centerPrincipalPoint=True)`` (``optimal_new_camera_matrix``), or the raw
  K under ``optimize_focal``;
* undistortion: ``cv2.initUndistortRectifyMap(..., CV_32FC1)`` maps
  (``undistort_maps``) and a bilinear ``cv2.remap`` with a zero border
  (``resample.remap_bilinear``); skipped when every distortion term is 0;
* SLAM stream (``to_slam``): long edge resized to ``target_size_slam``
  (OpenCV's INTER_AREA when shrinking, INTER_CUBIC when growing),
  centre-cropped to multiples of 16, in [-1, 1], with K_slam adjusted;
* map stream (``to_map``): INTER_AREA by ``downsample_map`` (any factor of
  at least 1), in [0, 1], with K_map.

Outputs are numpy (C, H, W) float32; device placement happens downstream.
"""

from __future__ import annotations


import numpy as np

from artdeco_tpu_torch.dataio import resample

_FLT_MAX = float(np.finfo(np.float32).max)


def _distortion(dist) -> np.ndarray:
    """OpenCV's 14 distortion terms (k1 k2 p1 p2 k3 k4 k5 k6 s1..s4 tx ty)
    from the 4 to 8 a calibration gives; the rest are 0."""
    k = np.zeros(14, np.float64)
    d = np.asarray(dist, np.float64).reshape(-1)
    k[:len(d)] = d
    if np.any(k[8:]):
        raise NotImplementedError("thin-prism and tilt distortion terms are not ported")
    return k


def undistort_points(uv: np.ndarray, K: np.ndarray, dist, P: np.ndarray,
                     iters: int = 5) -> np.ndarray:
    """``cv2.undistortPoints(uv, K, dist, None, P)``: (N, 2) float64 pixels
    of the distorted image to pixels of the ideal camera P, by OpenCV's
    fixed-point iteration (5 steps)."""
    k = _distortion(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    out = np.empty_like(uv, dtype=np.float64)
    for i, (u, v) in enumerate(np.asarray(uv, np.float64)):
        x0 = x = (u - cx) * ifx
        y0 = y = (v - cy) * ify
        for _ in range(iters):
            r2 = x * x + y * y
            icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                      / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
            if icdist < 0:
                x, y = (u - cx) * ifx, (v - cy) * ify
                break
            dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
            dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
            x = (x0 - dx) * icdist
            y = (y0 - dy) * icdist
        xx = P[0, 0] * x + P[0, 1] * y + P[0, 2]
        yy = P[1, 0] * x + P[1, 1] * y + P[1, 2]
        ww = 1.0 / (P[2, 0] * x + P[2, 1] * y + P[2, 2])
        out[i] = (xx * ww, yy * ww)
    return out


def optimal_new_camera_matrix(K: np.ndarray, dist, width: int, height: int) -> np.ndarray:
    """``cv2.getOptimalNewCameraMatrix(K, dist, (w, h), alpha=0, (w, h),
    centerPrincipalPoint=True)``: the principal point moves to the image's
    pixel centre and the focal scales so that only valid pixels remain.
    The inner rectangle comes from undistorting a 9x9 grid of points over
    the image, as OpenCV does."""
    K = np.asarray(K, np.float64)
    n = 9
    gx, gy = np.meshgrid(np.arange(n, dtype=np.float64) * (width - 1) / (n - 1),
                         np.arange(n, dtype=np.float64) * (height - 1) / (n - 1))
    pts = undistort_points(np.stack([gx.ravel(), gy.ravel()], -1), K, dist, K).reshape(n, n, 2)
    ix0, ix1 = max(-_FLT_MAX, pts[:, 0, 0].max()), min(_FLT_MAX, pts[:, n - 1, 0].min())
    iy0, iy1 = max(-_FLT_MAX, pts[0, :, 1].max()), min(_FLT_MAX, pts[n - 1, :, 1].min())
    iw, ih = ix1 - ix0, iy1 - iy0
    cx0, cy0 = K[0, 2], K[1, 2]
    cx, cy = (width - 1) * 0.5, (height - 1) * 0.5
    s = max(max(max(cx / (cx0 - ix0), cy / (cy0 - iy0)), cx / (ix0 + iw - cx0)),
            cy / (iy0 + ih - cy0))
    M = K.copy()
    M[0, 0] *= s
    M[1, 1] *= s
    M[0, 2], M[1, 2] = cx, cy
    return M


def undistort_maps(K: np.ndarray, dist, K_new: np.ndarray, width: int, height: int):
    """``cv2.initUndistortRectifyMap(K, dist, None, K_new, (w, h),
    CV_32FC1)``: for each pixel of the undistorted image, where to sample
    the distorted one.  Computed in float64, stored float32."""
    k = _distortion(dist)
    ir = np.linalg.inv(np.asarray(K_new, np.float64)).ravel()
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    i = np.arange(height, dtype=np.float64)[:, None]
    j = np.arange(width, dtype=np.float64)[None, :]
    _x = i * ir[1] + ir[2] + j * ir[0]
    _y = i * ir[4] + ir[5] + j * ir[3]
    _w = i * ir[7] + ir[8] + j * ir[6]
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = ((1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
          / (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2))
    xd = x * kr + k[2] * _2xy + k[3] * (r2 + 2 * x2)
    yd = y * kr + k[2] * (r2 + 2 * y2) + k[3] * _2xy
    return (fx * xd + u0).astype(np.float32), (fy * yd + v0).astype(np.float32)


def _resize_long_edge(img_u8: np.ndarray, long_edge: int) -> np.ndarray:
    h, w = img_u8.shape[:2]
    s = max(h, w)
    nw = int(round(w * long_edge / s))
    nh = int(round(h * long_edge / s))
    if s > long_edge:
        return resample.resize_area(img_u8, nw, nh)
    return resample.resize_cubic(img_u8, nw, nh)


def resize_img_slam(img: np.ndarray, size: int = 512, return_transformation: bool = False):
    """Long edge -> ``size``, centre-crop to multiples of 16, [-1, 1] CHW.

    img: (H, W, 3) float in [0, 1] or uint8.  A float image goes through
    uint8 by truncation, as in the JAX package.
    """
    if img.dtype != np.uint8:
        img_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    else:
        img_u8 = img
    H1, W1 = img_u8.shape[:2]
    r = _resize_long_edge(img_u8, size)
    H, W = r.shape[:2]
    cx, cy = W // 2, H // 2
    halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
    out = r[cy - halfh:cy + halfh, cx - halfw:cx + halfw]
    chw = out.astype(np.float32).transpose(2, 0, 1) / 255.0
    chw = chw * 2.0 - 1.0
    if return_transformation:
        return chw, (W1 / W, H1 / H, (W - out.shape[1]) / 2, (H - out.shape[0]) / 2)
    return chw


def slam_geometry(width: int, height: int, size: int):
    """The SLAM stream's crop of a (height, width) image, without resizing
    one: (H_slam, W_slam, scale_w, scale_h, half_crop_w, half_crop_h)."""
    s = max(height, width)
    rw, rh = int(round(width * size / s)), int(round(height * size / s))
    halfw, halfh = ((2 * (rw // 2)) // 16) * 8, ((2 * (rh // 2)) // 16) * 8
    return (2 * halfh, 2 * halfw, width / rw, height / rh,
            (rw - 2 * halfw) / 2, (rh - 2 * halfh) / 2)


class PinholeCamera:
    """Dual-resolution camera transform (the reference's
    ``CameraModel.py:66-163``).  ``calib_parameter`` is [fx, fy, cx, cy]
    followed by 0 to 8 distortion terms (k1 k2 p1 p2 k3 k4 k5 k6)."""

    def __init__(self, target_size_slam: int, downsample_map: float,
                 W_original: int, H_original: int, calib_parameter,
                 center_force: bool = True, optimize_focal: bool = False):
        self.target_size = target_size_slam
        self.W_original = W_original
        self.H_original = H_original
        fx, fy, cx, cy = calib_parameter[:4]
        K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)

        if optimize_focal:
            self.mapx = self.mapy = None
            self.K_best = K.astype(np.float32)
        else:
            if not center_force:
                raise NotImplementedError("centerPrincipalPoint=False is not ported")
            distortion = np.zeros(4)
            if len(calib_parameter) > 4:
                distortion = np.asarray(calib_parameter[4:], np.float64)
            K_best = optimal_new_camera_matrix(K, distortion, W_original, H_original)
            self.mapx, self.mapy = undistort_maps(K, distortion, K_best, W_original, H_original)
            if np.allclose(distortion, 0):
                # identity remap: skip the per-frame cost
                self.mapx = self.mapy = None
            self.K_best = K_best.astype(np.float32)

        # SLAM stream geometry
        (self.H_slam, self.W_slam, sw, sh, hcw, hch) = slam_geometry(
            W_original, H_original, target_size_slam)
        self.scale_slam_w, self.scale_slam_h = sw, sh
        self.half_crop_w, self.half_crop_h = hcw, hch
        K_slam = self.K_best.copy()
        K_slam[0, 0] /= sw
        K_slam[1, 1] /= sh
        K_slam[0, 2] = K_slam[0, 2] / sw - hcw
        K_slam[1, 2] = K_slam[1, 2] / sh - hch
        self.K_slam = K_slam.astype(np.float32)

        # map stream geometry
        if downsample_map < 1:
            raise NotImplementedError(
                f"map downsampling {downsample_map}: a map larger than the image is not ported")
        K_map = self.K_best.copy()
        K_map[:2] /= downsample_map
        self.K_map = K_map.astype(np.float32)
        self.downsample_map = downsample_map
        self.H_map = int(round(H_original / downsample_map))
        self.W_map = int(round(W_original / downsample_map))

    def _undistort(self, img: np.ndarray) -> np.ndarray:
        if self.mapx is not None:
            return resample.remap_bilinear(img, self.mapx, self.mapy)
        return img

    def to_slam(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8/float -> (3, H_slam, W_slam) f32 in [-1, 1]."""
        img = self._undistort(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return resize_img_slam(img, self.target_size)

    def to_map(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8/float -> (3, H_map, W_map) f32 in [0, 1]."""
        img = self._undistort(img)
        if img.dtype != np.uint8:
            img = img.astype(np.float32)
        out = resample.resize_area(img, self.W_map, self.H_map)
        if out.dtype == np.uint8:
            out = out.astype(np.float32) / 255.0
        return out.astype(np.float32).transpose(2, 0, 1)
