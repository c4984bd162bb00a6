"""Mapper losses and saliency helpers, plain PyTorch.

Port of ``artdeco_tpu/mapper/losses.py``.  One trap is kept exactly as the
JAX package has it: ``resize_bilinear`` says "align_corners=True" in the
JAX docstring, but ``jax.image.resize(..., "bilinear")`` samples at
half-pixel centres and antialiases when it downsamples.  Its counterpart
here is ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def radial_decay_kernel(h: int, w: int, sigma: float, device=None) -> torch.Tensor:
    y = torch.linspace(-1, 1, h, device=device)
    x = torch.linspace(-1, 1, w, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    r2 = xx * xx + yy * yy
    return torch.exp(-r2 / (2 * sigma * sigma))


def disc_kernel(radius: int = 3, device=None) -> torch.Tensor:
    """Normalized disc averaging kernel."""
    r = torch.arange(-radius, radius + 1, device=device, dtype=torch.float32)
    y, x = torch.meshgrid(r, r, indexing="ij")
    k = (torch.sqrt(x * x + y * y) <= radius + 0.5).float()
    return k / torch.sum(k)


def _conv_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'same' zero-padded correlation of (c, h, w) with a (kh, kw) kernel
    shared by all input channels, summed over channels -> (h, w).  The
    kernels used here are symmetric, so this is also the convolution."""
    kh, kw = kernel.shape
    w = kernel.expand(1, x.shape[0], kh, kw)
    return F.conv2d(x[None], w, padding=(kh // 2, kw // 2))[0, 0]


def lapla_norm(img: torch.Tensor, disc: torch.Tensor) -> torch.Tensor:
    """LoG saliency: |sum over channels of the Laplacian|, borders zeroed,
    disc-averaged, clamped to [0, 1]."""
    lap_k = torch.tensor([[0.0, 1, 0], [1, -4, 1], [0, 1, 0]], device=img.device)
    lap = torch.abs(_conv_same(img, lap_k))
    lap[:, 0] = 0.0
    lap[:, -1] = 0.0
    lap[0, :] = 0.0
    lap[-1, :] = 0.0
    return torch.clamp(_conv_same(lap[None], disc), 0.0, 1.0)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / torch.mean((img1 - img2) ** 2))


def avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """(c, h, w) -> (c, h//2, w//2) average pooling."""
    c, h, w = img.shape
    h2, w2 = h // 2, w // 2
    return img[:, : h2 * 2, : w2 * 2].reshape(c, h2, 2, w2, 2).mean(dim=(2, 4))


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of (c, H, W) with half-pixel centres, antialiased
    when downsampling: what ``jax.image.resize(..., "bilinear")`` computes
    (not align_corners=True, whatever the JAX docstring says)."""
    if tuple(img.shape[1:]) == (h, w):
        return img
    return F.interpolate(img[None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[0]


def grid_sample_bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (c, H, W) at float pixel coords uv (N, 2),
    align_corners=True convention (pixel centres at integers)."""
    c, h, w = img.shape
    u = torch.clamp(uv[:, 0], 0.0, w - 1.0)
    v = torch.clamp(uv[:, 1], 0.0, h - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp_max(u0 + 1, w - 1)
    v1 = torch.clamp_max(v0 + 1, h - 1)
    # the blend is summed in float64 and rounded once.  XLA fuses it into
    # one loop that rounds less often than eager float32 steps do; on a
    # plane of constant depth the float32 steps land one ulp below it,
    # which moves points across voxel boundaries (other cluster ids)
    du = (u - u0).double()[None]
    dv = (v - v0).double()[None]
    f = img.reshape(c, h * w).double()
    a = f[:, v0 * w + u0]
    b = f[:, v0 * w + u1]
    cc = f[:, v1 * w + u0]
    d = f[:, v1 * w + u1]
    return (a * (1 - du) * (1 - dv) + b * du * (1 - dv)
            + cc * (1 - du) * dv + d * du * dv).to(img.dtype)
