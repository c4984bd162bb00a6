"""Camera projection math with analytic Jacobians, in PyTorch.

Port of ``artdeco_tpu/geometry/projection.py``: point_to_ray_dist,
constrain_points_to_ray, project_calib, backproject, get_pixel_coords.
"""

from __future__ import annotations

import torch


def point_to_dist(X):
    return torch.linalg.vector_norm(X, dim=-1, keepdim=True)


def point_to_ray_dist(X, jacobian: bool = False):
    """Unit rays + distance, ``rd = [X/|X|, |X|]`` (dim 4); with
    ``jacobian=True`` also d(rd)/dX of shape (..., 4, 3)."""
    d = point_to_dist(X)
    d_inv = 1.0 / d
    r = d_inv * X
    rd = torch.cat([r, d], dim=-1)
    if not jacobian:
        return rd
    d_inv2 = d_inv * d_inv
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[:-1] + (3, 3))
    outer = X[..., :, None] * X[..., None, :]
    dr_dX = d_inv[..., None] * (eye - d_inv2[..., None] * outer)
    dd_dX = r[..., None, :]
    return rd, torch.cat([dr_dX, dd_dX], dim=-2)


def decompose_K(K):
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def backproject(p, z, K):
    """Pixels (..., 2) + depth (..., 1) + intrinsics (3, 3) -> camera
    points (..., 3)."""
    fx, fy, cx, cy = decompose_K(K)
    x = (p[..., 0] - cx) / fx
    y = (p[..., 1] - cy) / fy
    return z * torch.stack([x, y, torch.ones_like(x)], dim=-1)


def get_pixel_coords(img_size, dtype=torch.float32, batch: int | None = None, *, device):
    """(h, w) -> pixel grid (h*w, 2) in (u, v) order, row-major."""
    h, w = img_size
    vv, uu = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    uv = torch.stack([uu, vv], dim=-1).reshape(-1, 2)
    if batch is not None:
        uv = uv.expand((batch,) + uv.shape)
    return uv


def constrain_points_to_ray(img_size, Xs, K):
    """Re-backproject a pointmap (..., h*w, 3) from its z alone, snapping
    x/y to the pixel rays."""
    uv = get_pixel_coords(img_size, dtype=Xs.dtype, device=Xs.device)
    uv = uv.expand(Xs.shape[:-1] + (2,))
    return backproject(uv, Xs[..., 2:3], K)


def project_calib(P, K, img_size, jacobian: bool = False, border: int = 0,
                  z_eps: float = 0.0, dP_df=None):
    """Project camera points to (u, v, log z) with validity gating.

    Returns ``(pz, valid)`` or ``(pz, dpz_dP (..., 3, 4), valid)``; the 4th
    Jacobian column is d/d(focal) when ``dP_df`` (..., 3, 1) is given."""
    h, w = img_size
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P[..., 0:1], P[..., 1:2], P[..., 2:3]
    valid_z = z > z_eps
    z_safe = torch.where(valid_z, z, torch.ones_like(z))
    u = fx * x / z_safe + cx
    v = fy * y / z_safe + cy

    valid_u = (u > border) & (u < w - 1 - border)
    valid_v = (v > border) & (v < h - 1 - border)
    valid = valid_u & valid_v & valid_z

    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z))
    pz = torch.cat([u, v, logz], dim=-1)
    if not jacobian:
        return pz, valid

    z_inv = torch.where(valid_z[..., 0], 1.0 / z_safe[..., 0], torch.ones_like(z[..., 0]))
    zero = torch.zeros_like(z_inv)
    x0, y0 = x[..., 0], y[..., 0]
    j00 = fx * z_inv
    j11 = fy * z_inv
    j02 = -fx * x0 * z_inv * z_inv
    j12 = -fy * y0 * z_inv * z_inv
    j22 = z_inv
    if dP_df is None:
        j03 = j13 = j23 = zero
    else:
        dXdf, dYdf, dZdf = dP_df[..., 0, 0], dP_df[..., 1, 0], dP_df[..., 2, 0]
        z0 = z[..., 0]
        # the reference's z^2 factor, transcribed as the JAX package has it
        j03 = x0 * z_inv + fx * (dXdf * z0 - dZdf * x0) * z0 * z0
        j13 = y0 * z_inv + fy * (dYdf * z0 - dZdf * y0) * z0 * z0
        j23 = z_inv * dZdf
    dpz_dP = torch.stack([
        torch.stack([j00, zero, j02, j03], dim=-1),
        torch.stack([zero, j11, j12, j13], dim=-1),
        torch.stack([zero, zero, j22, j23], dim=-1),
    ], dim=-2)
    return pz, dpz_dP, valid
