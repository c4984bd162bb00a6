"""SSIM (11x11 Gaussian window), plain PyTorch.

Port of ``artdeco_tpu/ops/ssim.py``: zero-padded separable Gaussian blur
(two ``conv2d`` passes), the SSIM formula, loss = map mean.  Autograd of a
convolution is a convolution, so no hand-written backward is needed.

On the card a float32 ``conv2d`` runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; callers that compare with a
float32 reference turn it off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_WIN = 11
_SIGMA = 1.5
_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _gaussian_kernel(dtype, device) -> torch.Tensor:
    x = torch.arange(_WIN, dtype=dtype, device=device) - (_WIN - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * _SIGMA * _SIGMA))
    return g / torch.sum(g)


def _blur2d(img: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded 11x11 Gaussian filter over (..., H, W)."""
    shape = img.shape
    x = img.reshape(-1, 1, shape[-2], shape[-1])
    g = _gaussian_kernel(img.dtype, img.device)
    pad = _WIN // 2
    x = F.conv2d(x, g.view(1, 1, _WIN, 1), padding=(pad, 0))
    x = F.conv2d(x, g.view(1, 1, 1, _WIN), padding=(0, pad))
    return x.reshape(shape)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             padding: str = "same") -> torch.Tensor:
    """Per-pixel SSIM over (..., H, W) images in [0, 1]; "valid" crops 5 px."""
    mu1 = _blur2d(img1)
    mu2 = _blur2d(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur2d(img1 * img1) - mu1_sq
    sigma2_sq = _blur2d(img2 * img2) - mu2_sq
    sigma12 = _blur2d(img1 * img2) - mu12
    m = ((2.0 * mu12 + _C1) * (2.0 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )
    if padding == "valid":
        m = m[..., 5:-5, 5:-5]
    return m


def fused_ssim(img1: torch.Tensor, img2: torch.Tensor,
               padding: str = "same") -> torch.Tensor:
    """Scalar SSIM score = mean of the SSIM map."""
    return torch.mean(ssim_map(img1, img2, padding))
