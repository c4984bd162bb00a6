"""Pinhole camera geometry of the port's datasets.

Port of ``artdeco_tpu/dataio/camera.py`` for cameras without lens
distortion, in numpy alone (no OpenCV): the dual SLAM/map resolutions and
their intrinsics.

* SLAM stream: long edge resized to ``target_size_slam``, centre-cropped
  to multiples of 16, with K_slam adjusted; ``to_slam`` gives the image in
  [-1, 1].  Where the long edge already has the target size the image is
  only cropped, as OpenCV's resize to the same size copies it; other
  sizes are resampled with PyTorch (area when shrinking, bicubic when
  growing), which is close to OpenCV's but not bit-equal.
* map stream: downsampled by an integer ``downsample_map`` (an area
  average with OpenCV's rounding for uint8 frames), with K_map.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def optimal_new_camera_matrix(K: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.getOptimalNewCameraMatrix(K, 0, (w, h), alpha=0, (w, h),
    centerPrincipalPoint=True)`` for zero distortion: the principal point
    moves to the pixel centre of the image and the focal scales so that the
    image corners stay inside it."""
    cx0, cy0 = K[0, 2], K[1, 2]
    cx, cy = (width - 1) * 0.5, (height - 1) * 0.5
    s = max(cx / cx0, cy / cy0, cx / (width - 1 - cx0), cy / (height - 1 - cy0))
    M = np.asarray(K, np.float64).copy()
    M[0, 0] *= s
    M[1, 1] *= s
    M[0, 2], M[1, 2] = cx, cy
    return M


def slam_geometry(width: int, height: int, size: int):
    """The SLAM stream's crop of a (height, width) image: long edge resized
    to ``size``, then centre-cropped to multiples of 16.  Returns
    (H_slam, W_slam, scale_w, scale_h, half_crop_w, half_crop_h)."""
    s = max(height, width)
    rw, rh = int(round(width * size / s)), int(round(height * size / s))
    halfw, halfh = ((2 * (rw // 2)) // 16) * 8, ((2 * (rh // 2)) // 16) * 8
    return (2 * halfh, 2 * halfw, width / rw, height / rh,
            (rw - 2 * halfw) / 2, (rh - 2 * halfh) / 2)


class PinholeCamera:
    """Dual-resolution camera transform without lens distortion."""

    def __init__(self, target_size_slam: int, W_original: int, H_original: int,
                 calib_parameter, downsample_map: float = 1.0):
        fx, fy, cx, cy = calib_parameter  # pinhole only: no distortion terms
        K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        self.K_best = optimal_new_camera_matrix(K, W_original, H_original).astype(np.float32)

        (self.H_slam, self.W_slam, sw, sh, hcw, hch) = slam_geometry(
            W_original, H_original, target_size_slam)
        K_slam = self.K_best.copy()
        K_slam[0, 0] /= sw
        K_slam[1, 1] /= sh
        K_slam[0, 2] = K_slam[0, 2] / sw - hcw
        K_slam[1, 2] = K_slam[1, 2] / sh - hch
        self.K_slam = K_slam.astype(np.float32)

        if downsample_map != int(downsample_map) or downsample_map < 1:
            raise NotImplementedError(
                f"map downsampling {downsample_map}: only integer factors are ported")
        K_map = self.K_best.copy()
        K_map[:2] /= downsample_map
        self.K_map = K_map.astype(np.float32)
        self.downsample_map = int(downsample_map)
        self.H_map = int(round(H_original / downsample_map))
        self.W_map = int(round(W_original / downsample_map))
        self.target_size = target_size_slam

    def to_slam(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8/float -> (3, H_slam, W_slam) f32 in [-1, 1]."""
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        # the JAX package's round trip through uint8, truncation included
        img_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        h, w = img_u8.shape[:2]
        s = max(h, w)
        nw, nh = int(round(w * self.target_size / s)), int(round(h * self.target_size / s))
        if (nh, nw) != (h, w):
            x = torch.from_numpy(img_u8).permute(2, 0, 1)[None].float()
            mode = dict(mode="area") if s > self.target_size else dict(
                mode="bicubic", align_corners=False)
            x = F.interpolate(x, size=(nh, nw), **mode)
            img_u8 = x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
        cx, cy = nw // 2, nh // 2
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        out = img_u8[cy - halfh:cy + halfh, cx - halfw:cx + halfw]
        return out.astype(np.float32).transpose(2, 0, 1) / 255.0 * 2.0 - 1.0

    def to_map(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8/float -> (3, H_map, W_map) f32 in [0, 1]."""
        k = self.downsample_map
        if k > 1:
            h, w = self.H_map * k, self.W_map * k
            blocks = img[:h, :w].reshape(self.H_map, k, self.W_map, k, -1)
            if img.dtype == np.uint8:
                # OpenCV's INTER_AREA at an integer factor: the rounded mean
                s = blocks.astype(np.int64).sum(axis=(1, 3))
                img = ((s * 2 + k * k) // (2 * k * k)).astype(np.uint8)
            else:
                img = blocks.astype(np.float32).mean(axis=(1, 3))
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return img.astype(np.float32).transpose(2, 0, 1)
