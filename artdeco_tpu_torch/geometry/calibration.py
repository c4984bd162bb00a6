"""Self-calibration from model pointmaps.

Port of ``artdeco_tpu/geometry/calibration.py``: when no intrinsics are
given, the focal is estimated from the first frame's mono pointmap by a
robust Weiszfeld/IRLS fit of ``(u - cx, v - cy) ~ f * (x/z, y/z)`` with
the principal point at the image centre.

The fit runs once per run, on the host, in numpy float32.  Its fixed point
at an exact focal is unstable: the exact inliers weigh 1e6 (a residual of
0 clamped at 1e-6) only while the focal stays on the float32 value whose
residuals round to 0, and one ulp away their weight falls a hundredfold.
On ``tests/test_calibration.py``'s outlier case a float64 fit drifts from
140 to 130.5 px in ten iterations, and so does a float32 fit whose sums
round differently; numpy's pairwise float32 sums round as the JAX
package's do there and stay on 140.
"""

from __future__ import annotations

import numpy as np
import torch


def estimate_focal_weiszfeld(X, valid, height: int, width: int, iters: int = 10):
    """Robust (L1/Weiszfeld) single-focal estimate from a (H*W, 3)
    camera-frame pointmap and a (H*W,) validity gate (tensors or arrays).
    Returns a 0-d float32 tensor: the focal in pixels at the pointmap's
    resolution."""
    dev = X.device if isinstance(X, torch.Tensor) else torch.device("cpu")
    X = (X.detach().cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X))
    X = X.astype(np.float32)
    valid = (valid.detach().cpu().numpy() if isinstance(valid, torch.Tensor)
             else np.asarray(valid)).astype(bool)
    u, v = np.meshgrid(np.arange(width, dtype=np.float32),
                       np.arange(height, dtype=np.float32))
    uv = np.stack([(u - np.float32((width - 1) / 2.0)).reshape(-1),
                   (v - np.float32((height - 1) / 2.0)).reshape(-1)], axis=-1)
    z = np.where(np.abs(X[:, 2]) > 1e-9, X[:, 2], np.float32(1e-9))
    xz = np.stack([X[:, 0] / z, X[:, 1] / z], axis=-1)
    vm = (valid & (X[:, 2] > 1e-6)).astype(np.float32)
    dot = np.sum(uv * xz, axis=-1)
    nrm = np.sum(xz * xz, axis=-1)
    # robust start: the median of the per-pixel scale ratios |uv| / |xz|
    ratio = np.linalg.norm(uv, axis=-1) / np.maximum(np.linalg.norm(xz, axis=-1),
                                                      np.float32(1e-9))
    f = np.float32(np.nanmedian(np.where(vm > 0, ratio, np.float32(np.nan))))
    for _ in range(iters):
        r = np.linalg.norm(uv - f * xz, axis=-1)
        w = vm / np.maximum(r, np.float32(1e-6))
        f = np.float32(np.sum(w * dot) / np.maximum(np.sum(w * nrm), np.float32(1e-9)))
    return torch.tensor(max(f, np.float32(1e-3)), dtype=torch.float32, device=dev)
