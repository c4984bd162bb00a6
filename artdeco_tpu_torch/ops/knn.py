"""Approximate k-nearest-neighbour distances over Morton-sorted windows.

Port of ``artdeco_tpu/ops/knn.py`` (the ``distCUDA2`` surface of the
reference's simple-knn extension): sort the points by their 30-bit Morton
code once, then take each point's k smallest squared distances among its
+-``window`` neighbours in that order.  Plain PyTorch: the JAX package
computes it in XLA, not in a Pallas kernel.

The Morton interleave multiplies in uint32 with wrap-around in the JAX
package.  PyTorch's uint32 lacks most arithmetic on CUDA, so it runs in
int64 here; every mask that follows a multiply is below 2^32, so it also
cuts the product to 32 bits, and the codes are the same.
"""

from __future__ import annotations

import torch

from artdeco_tpu_torch.device import resolve


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (the Morton interleave helper), int64."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(xyz: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of points normalised into their AABB."""
    mn = xyz.min(dim=0, keepdim=True).values
    mx = xyz.max(dim=0, keepdim=True).values
    u = (xyz - mn) / torch.clamp(mx - mn, min=1e-12)
    q = torch.clamp(u * 1023.0, 0, 1023).to(torch.int64)   # truncation, as astype(uint32)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | _expand_bits(q[:, 2])


def knn_mean_sq_dist(xyz, k: int = 3, window: int = 16, *, device=None) -> torch.Tensor:
    """Mean squared distance of each point to its (approximate) k nearest
    neighbours: the k smallest among its +-``window`` neighbours in Morton
    order.  ``xyz`` (N, 3); a tensor stays on its device, an array goes to
    ``device`` (None: the CUDA device).  Returns (N,) float32."""
    if not isinstance(xyz, torch.Tensor):
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=resolve(device))
    n = xyz.shape[0]
    order = torch.argsort(morton_codes(xyz), stable=True)
    pts = xyz[order]
    idx = torch.arange(n, device=xyz.device)
    dists = []
    for off in range(1, window + 1):
        for sign in (1, -1):
            d = torch.sum((pts - torch.roll(pts, sign * off, dims=0)) ** 2, dim=-1)
            # pairs that wrap around the ends are no neighbours
            bad = (idx - sign * off < 0) | (idx - sign * off >= n)
            dists.append(torch.where(bad, torch.inf, d))
    dmat = torch.stack(dists, dim=-1)                      # (N, 2 * window)
    mean_knn = torch.topk(dmat, k, dim=-1, largest=False).values.mean(dim=-1)
    out = torch.empty_like(mean_knn)
    out[order] = mean_knn
    return out
