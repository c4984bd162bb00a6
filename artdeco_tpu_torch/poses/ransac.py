"""Batched RANSAC: normalised 8-point fundamental matrices and Sampson
inlier counting.

Port of ``artdeco_tpu/poses/ransac.py``: every hypothesis is estimated at
once (a batched SVD), and the Sampson errors of all correspondences under
all hypotheses are evaluated together.  The sample sets come from
``np.random.RandomState(seed)``, as in the JAX package, so both draw the
same indices.  The SVD's null vector has a free sign; the final division
by F[2, 2] removes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _normalize_pts(p: torch.Tensor):
    """Hartley normalisation of (B, m, 2) points: zero mean, sqrt(2) mean
    distance.  Returns (normalised points, T (B, 3, 3))."""
    mu = p.mean(dim=1)
    d = torch.sqrt(torch.sum((p - mu[:, None]) ** 2, dim=2)).mean(dim=1)
    s = torch.full_like(d, math.sqrt(2.0)) / torch.clamp(d, min=1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mu[:, 0]], -1),
        torch.stack([zero, s, -s * mu[:, 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=1)
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=2)
    return (T @ ph.transpose(1, 2)).transpose(1, 2)[..., :2], T


def fund_8pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Fundamental matrices (B, 3, 3) from (B, 8, 2) correspondences: DLT,
    rank 2, denormalised, scaled to F[2, 2] = 1."""
    p1n, T1 = _normalize_pts(p1)
    p2n, T2 = _normalize_pts(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=2)
    _, _, Vt = torch.linalg.svd(A)
    F = Vt[:, -1].reshape(-1, 3, 3)
    U, S, Vt2 = torch.linalg.svd(F)
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], dim=1)
    F = U @ torch.diag_embed(S) @ Vt2
    F = T2.transpose(1, 2) @ F @ T1
    f22 = F[:, 2, 2]
    return F / torch.clamp(f22.abs(), min=1e-12)[:, None, None] \
        * torch.sign(f22 + 1e-30)[:, None, None]


def sampson_error(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Sampson distances (..., n) of all correspondences under F (..., 3, 3)."""
    ph1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
    ph2 = torch.cat([p2, torch.ones_like(p2[:, :1])], dim=1)
    Fx1 = ph1 @ F.transpose(-1, -2)          # (..., n, 3)
    Ftx2 = ph2 @ F                           # (..., n, 3)
    num = torch.sum(ph2 * Fx1, dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def batch_fundamental_ransac(mkpts1: torch.Tensor, mkpts2: torch.Tensor,
                             sample_idx: torch.Tensor, max_error: float):
    """Estimate N hypotheses from ``sample_idx`` (N, 8), count Sampson
    inliers, return the best: (F (3, 3), inlier mask (n,), count)."""
    Fs = fund_8pt(mkpts1[sample_idx], mkpts2[sample_idx])
    inliers = sampson_error(Fs, mkpts1, mkpts2) < max_error     # (N, n)
    counts = inliers.sum(dim=1)
    best = torch.argmax(counts)
    return Fs[best], inliers[best], counts[best]


class RANSACEstimator:
    """The reference estimator's surface; runs where its inputs lie."""

    def __init__(self, N: int, max_error: float, seed: int = 0):
        self.N = N
        self.max_error = max_error
        self.seed = seed

    def estimate(self, mkpts1: torch.Tensor, mkpts2: torch.Tensor):
        n = int(mkpts1.shape[0])
        rng = np.random.RandomState(self.seed)
        idx = rng.randint(0, max(n, 1), size=(self.N, 8)).astype(np.int64)
        return batch_fundamental_ransac(mkpts1, mkpts2,
                                        torch.as_tensor(idx, device=mkpts1.device),
                                        self.max_error)
