"""Monocular inverse depth with a gradient confidence, and dense descriptors.

Port of ``artdeco_tpu/mapper/mono_depth.py`` (the legacy interface).  Both
providers are host-side numpy around a pluggable ``model_fn``:
``MonoDepthEstimator(model_fn=models.depth_anything.make_dav2_model_fn())``
runs DepthAnythingV2 on the card, ``DenseExtractor(model_fn=
models.xfeat.make_dense_fn())`` XFeat's dense descriptors.  Without a model
the estimator derives inverse depth from a SLAM pointmap, and the
extractor stacks multi-scale intensity and gradient channels.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def idepth_from_pointmap(point_map: np.ndarray) -> np.ndarray:
    """(H, W, 3) SLAM pointmap -> (H, W) inverse depth."""
    z = point_map[..., 2]
    return np.where(z != 0, 1.0 / (z + 1e-4), 1e4).astype(np.float32)


def gradient_confidence(idepth: np.ndarray, scale: float = 10.0) -> np.ndarray:
    """Down-weight depth discontinuities."""
    gy, gx = np.gradient(idepth)
    g = np.sqrt(gx * gx + gy * gy)
    return np.exp(-scale * g).astype(np.float32)


class MonoDepthEstimator:
    """``model_fn(img_chw) -> idepth (H, W)``, a learned monocular network,
    or inverse depth from a pointmap; returns (idepth, confidence)."""

    def __init__(self, model_fn: Optional[Callable] = None):
        self.model_fn = model_fn

    def __call__(self, img_chw: np.ndarray, point_map: Optional[np.ndarray] = None):
        if self.model_fn is not None:
            idepth = np.asarray(self.model_fn(img_chw), np.float32)
        elif point_map is not None:
            idepth = idepth_from_pointmap(point_map)
        else:
            raise ValueError("no mono-depth model and no pointmap provided")
        return idepth, gradient_confidence(idepth)


class DenseExtractor:
    """Dense per-pixel descriptors: ``model_fn(img_chw)``, or by default
    ``dim`` channels of intensity, gradients and repeated 4-neighbour
    blurs, L2-normalised."""

    def __init__(self, model_fn: Optional[Callable] = None, dim: int = 8):
        self.model_fn = model_fn
        self.dim = dim

    def __call__(self, img_chw: np.ndarray) -> np.ndarray:
        if self.model_fn is not None:
            return np.asarray(self.model_fn(img_chw), np.float32)
        gray = img_chw.mean(axis=0)
        gy, gx = np.gradient(gray)
        feats = [gray, gx, gy, np.abs(gx) + np.abs(gy)]
        g2 = gray
        while len(feats) < self.dim:
            g2 = 0.25 * (np.roll(g2, 1, 0) + np.roll(g2, -1, 0)
                         + np.roll(g2, 1, 1) + np.roll(g2, -1, 1))
            feats.append(g2)
        d = np.stack(feats[: self.dim], axis=-1)
        n = np.linalg.norm(d, axis=-1, keepdims=True)
        return (d / np.maximum(n, 1e-12)).astype(np.float32)
