"""Local diagonal covariance of pointmaps via box filtering.

Port of ``artdeco_tpu/geometry/uncertainty.py``: box-filtered E[X],
E[X^2] over a win x win reflect-padded window, variance per channel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _boxfilter(img_hwc, win: int):
    """Mean filter with reflect padding, separable (h then w); the window
    sums run in sequence from the window's first tap, as XLA's
    reduce_window does."""
    pad = win // 2
    H, W = img_hwc.shape[:2]
    x = F.pad(img_hwc.permute(2, 0, 1)[None], (pad, pad, pad, pad),
              mode="reflect")[0].permute(1, 2, 0)
    acc = torch.zeros_like(x[:H])
    for k in range(win):
        acc = acc + x[k:k + H]
    out = torch.zeros_like(acc[:, :W])
    for k in range(win):
        out = out + acc[:, k:k + W]
    return out / float(win * win)


def local_diag_cov(X, H: int, W: int, win: int = 5, valid=None, var_floor: float = 1e-12):
    """Per-pixel local variance of a pointmap: X (H*W, 3) -> (H*W, 3)."""
    Xv = X.reshape(H, W, 3)
    if valid is None:
        valid_hw1 = (torch.isfinite(Xv).all(-1) & (Xv[..., 2] > 0)).to(X.dtype)[..., None]
    else:
        valid_hw1 = valid.reshape(H, W, 1).to(X.dtype)
    denom = torch.clamp_min(_boxfilter(valid_hw1, win), 1e-9)
    mean = _boxfilter(Xv * valid_hw1, win) / denom
    ex2 = _boxfilter(Xv * Xv * valid_hw1, win) / denom
    var = torch.clamp_min(ex2 - mean * mean, var_floor)
    return var.reshape(H * W, 3)


def diag_to_cov(var):
    """(N, 3) diagonal variances -> (N, 3, 3) covariance matrices."""
    return torch.diag_embed(var)
