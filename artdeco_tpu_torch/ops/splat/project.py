"""3D Gaussian -> 2D screen projection (EWA splatting).

Port of ``artdeco_tpu/ops/splat/project.py``: the eps2d low-pass filter,
antialias compensations and near/far/radius culling, as elementwise torch
math over N.  Autograd reaches every input, including the view matrix
(which drives the keyframe pose Adam).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Projected(NamedTuple):
    means2d: torch.Tensor        # (N, 2) pixel coords
    conics: torch.Tensor         # (N, 3) upper-tri inverse 2D covariance
    depths: torch.Tensor         # (N,) camera z
    radii: torch.Tensor          # (N, 2) per-axis 3-sigma radii (0 if culled)
    compensations: torch.Tensor  # (N,) antialias opacity scale


def _normalize_quat(quats: torch.Tensor) -> torch.Tensor:
    # eps inside the sqrt: zero quats (inactive rows) must not give NaN grads
    return quats * torch.rsqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-20)


def quat_scale_to_cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N,4) wxyz quats (unnormalized ok) + (N,3) scales -> (N,3,3)."""
    q = _normalize_quat(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    ).reshape(q.shape[:-1] + (3, 3))
    M = R * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def _rot_wxyz_inv(quats: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors by the inverse of wxyz quats, elementwise."""
    qn = _normalize_quat(quats)
    qv = -qn[..., 1:4]
    qw = qn[..., 0:1]
    uv = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * uv + torch.linalg.cross(qv, uv, dim=-1)


def project_gaussians(
    means: torch.Tensor,     # (N, 3) world
    quats: torch.Tensor,     # (N, 4) wxyz
    scales: torch.Tensor,    # (N, 3)
    viewmat: torch.Tensor,   # (4, 4) world->cam
    K: torch.Tensor,         # (3, 3)
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    antialiased: bool = False,
    radius_clip: float = 0.0,
    frustum_hw: Optional[tuple] = None,
    row0: int = 0,
) -> Projected:
    """``row0``: project onto rows [row0, row0 + height) of the image ``K``
    sees (a row strip; ``frustum_hw`` then the image's (H, W)).  Pixel
    coordinates are the image's moved up by ``row0``: the difference is
    exact for every Gaussian that can reach the strip (v >= row0 / 2), so
    a strip's pixel-Gaussian pairs are the whole image's, bit for bit."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    p_cam = means @ R.T + t
    z = p_cam[..., 2]

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    z_safe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    u = fx * p_cam[..., 0] / z_safe + cx
    v = fy * p_cam[..., 1] / z_safe + cy
    means2d = torch.stack([u, v - row0 if row0 else v], dim=-1)

    # EWA: cov2d = J W cov3d W^T J^T with the frustum-clamped Jacobian; with
    # M = R(q) diag(s), cov2d[ij] = <u_i, u_j> for u = s * R(q)^-1 a
    f_h, f_w = frustum_hw if frustum_hw is not None else (height, width)
    lim_x = 1.3 * (0.5 * f_w / fx)
    lim_y = 1.3 * (0.5 * f_h / fy)
    tx = z_safe * torch.clamp(p_cam[..., 0] / z_safe, -lim_x, lim_x)
    ty = z_safe * torch.clamp(p_cam[..., 1] / z_safe, -lim_y, lim_y)

    z_inv = 1.0 / z_safe
    j00 = (fx * z_inv)[..., None]
    j02 = (-fx * tx * z_inv * z_inv)[..., None]
    j11 = (fy * z_inv)[..., None]
    j12 = (-fy * ty * z_inv * z_inv)[..., None]
    a = j00 * R[0][None, :] + j02 * R[2][None, :]
    b = j11 * R[1][None, :] + j12 * R[2][None, :]
    ma = scales * _rot_wxyz_inv(quats, a)
    mb = scales * _rot_wxyz_inv(quats, b)
    c00 = torch.sum(ma * ma, dim=-1)
    c01 = torch.sum(ma * mb, dim=-1)
    c11 = torch.sum(mb * mb, dim=-1)

    det_orig = c00 * c11 - c01 * c01
    c00 = c00 + eps2d
    c11 = c11 + eps2d
    det = c00 * c11 - c01 * c01
    det_safe = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    if antialiased:
        compensations = torch.sqrt(torch.clamp_min(det_orig / det_safe, 0.0))
    else:
        compensations = torch.ones_like(det)

    conics = torch.stack([c11 / det_safe, -c01 / det_safe, c00 / det_safe], dim=-1)

    # per-axis 3-sigma extent (sqrt of the diagonal)
    rx = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(c00, 0.0)))
    ry = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(c11, 0.0)))

    valid = (
        (z > near_plane)
        & (z < far_plane)
        & (det > 0)
        & (u + rx > 0) & (u - rx < width)
        & (v + ry > row0) & (v - ry < row0 + height)
        & (torch.maximum(rx, ry) > radius_clip)
    )
    radii = torch.where(valid[..., None], torch.stack([rx, ry], -1), torch.zeros_like(means2d))
    return Projected(means2d, conics, z, radii, compensations)
