"""Keypoint detection with descriptors.

Port of ``artdeco_tpu/poses/feature_detector.py``.  The default detector is
the JAX package's Shi-Tomasi corner response with non-maximum suppression
and mean-normalised 8x8 patch descriptors; with an XFeat checkpoint (or
``$ARTDECO_XFEAT_NPZ``) the learned detector of ``models/xfeat.py`` runs
instead, under the same (kpts, scores, desc) interface.

Order matters for parity: the keypoints are the ``num_kpts`` highest
scores, equal scores in ascending flat index (``lax.top_k``'s order).  On
a smooth image most of them score 0 and come from the image's first row;
a stable descending sort keeps that order (``torch.topk`` leaves the order
of equal values unspecified).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F

from artdeco_tpu_torch.device import resolve


@dataclasses.dataclass
class DescribedKeypoints:
    kpts: torch.Tensor      # (P, 2) pixel coordinates (u, v)
    scores: torch.Tensor    # (P,)
    desc: torch.Tensor      # (P, D) unit descriptors
    matches: dict = dataclasses.field(default_factory=dict)


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest values of a 1-D tensor and their indices, equal values
    in ascending index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def channel_mean(img: torch.Tensor) -> torch.Tensor:
    """The mean of a (C, H, W) image over its channels, summed in order and
    scaled by 1 / C, as XLA computes ``mean(axis=0)``."""
    return img.sum(dim=0) * (1.0 / img.shape[0])


def gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` at unit spacing: central differences inside,
    one-sided differences at both ends."""
    n = a.shape[dim]
    upper = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    lower = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim=dim)


def _gauss_blur(img: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """Separable Gaussian blur with zero padding, the taps summed in order."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    h, w = img.shape
    p = F.pad(img, (0, 0, radius, radius))
    acc = g[0] * p[0:h]
    for i in range(1, 2 * radius + 1):
        acc = acc + g[i] * p[i:i + h]
    p = F.pad(acc, (radius, radius))
    acc = g[0] * p[:, 0:w]
    for i in range(1, 2 * radius + 1):
        acc = acc + g[i] * p[:, i:i + w]
    return acc


def detect_keypoints(gray: torch.Tensor, num_kpts: int = 1024, nms_radius: int = 4,
                     patch: int = 8):
    """Shi-Tomasi corners, NMS and normalised patch descriptors of a (H, W)
    image in [0, 1].  Returns (kpts (P, 2) float, scores (P,), desc
    (P, patch * patch))."""
    h, w = gray.shape
    gx = gradient(gray, 1)
    gy = gradient(gray, 0)
    Ixx = _gauss_blur(gx * gx)
    Iyy = _gauss_blur(gy * gy)
    Ixy = _gauss_blur(gx * gy)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    response = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))   # min eigenvalue

    # NMS by max-pool comparison (the pool pads with -inf, as reduce_window "SAME")
    win = 2 * nms_radius + 1
    pooled = F.max_pool2d(response[None, None], win, stride=1, padding=nms_radius)[0, 0]
    is_peak = (response >= pooled) & (response > 0)
    m = torch.zeros_like(response)
    m[patch:-patch, patch:-patch] = 1.0        # no keypoint whose patch leaves the image
    score_map = torch.where(is_peak, response, 0.0) * m

    scores, idx = top_k_stable(score_map.reshape(-1), num_kpts)
    u = (idx % w).to(torch.float32)
    v = (idx // w).to(torch.float32)
    kpts = torch.stack([u, v], dim=1)

    offs = torch.arange(-(patch // 2), patch // 2, device=gray.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    samp_v = torch.clamp(v[:, None, None].to(torch.int64) + oy, 0, h - 1)
    samp_u = torch.clamp(u[:, None, None].to(torch.int64) + ox, 0, w - 1)
    patches = gray[samp_v, samp_u].reshape(num_kpts, -1)
    patches = patches - patches.mean(dim=1, keepdim=True)
    desc = patches * torch.rsqrt(torch.sum(patches * patches, dim=1, keepdim=True) + 1e-12)
    return kpts, scores, desc


class FeatureDetector:
    """The detector's surface: ``detector(img_chw) -> DescribedKeypoints``
    on ``device`` (None: the CUDA device).

    With ``xfeat_checkpoint`` (or ``$ARTDECO_XFEAT_NPZ``), a torch ``.pth``
    or ``.safetensors`` XFeat checkpoint, the learned detector runs;
    otherwise ``describe_fn(gray) -> (kpts, scores, desc)``, by default
    the Shi-Tomasi detector."""

    def __init__(self, num_kpts: int = 1024, describe_fn=None, xfeat_checkpoint: str = "",
                 *, device=None):
        self.num_kpts = num_kpts
        self.device = resolve(device)
        self._xfeat = None
        xfeat_checkpoint = xfeat_checkpoint or os.environ.get("ARTDECO_XFEAT_NPZ", "")
        if describe_fn is None and xfeat_checkpoint:
            from artdeco_tpu_torch.models.xfeat import make_detector

            self._xfeat = make_detector(xfeat_checkpoint, top_k=num_kpts, device=self.device)
        self.describe_fn = describe_fn or (lambda g: detect_keypoints(g, num_kpts=self.num_kpts))

    def __call__(self, img_chw) -> DescribedKeypoints:
        img = torch.as_tensor(img_chw, dtype=torch.float32, device=self.device)
        if self._xfeat is not None:
            kpts, desc, scores = self._xfeat(img)
            return DescribedKeypoints(kpts=kpts, scores=scores, desc=desc)
        gray = channel_mean(img)
        if float(gray.min()) < -0.01:           # [-1, 1] -> [0, 1]
            gray = (gray + 1.0) / 2.0
        kpts, scores, desc = self.describe_fn(gray)
        return DescribedKeypoints(kpts=kpts, scores=scores, desc=desc)
