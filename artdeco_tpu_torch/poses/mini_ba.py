"""Mini bundle adjustment: Gauss-Newton over 6D-rotation poses,
translations, an optional focal and optional 3D points.

Port of ``artdeco_tpu/poses/mini_ba.py``: the flat residual's Jacobian by
forward-mode differentiation (``torch.func.jacfwd`` for ``jax.jacfwd``),
Huber weights, Marquardt-damped dense normal equations solved in float32
and a step clamped to norm 0.5.  At the bootstrap's size (2 cameras, P
points, ``optimize_pts``) the Jacobian is (3 * 2 * P) x (18 + 3 P).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from artdeco_tpu_torch.mapper.keyframe import sixd_to_mtx


def project(xyz, R6D, t, f, centre):
    """World points (..., P, 3) -> pixels (..., P, 2) and camera z under
    (R6D (..., 3, 2), t (..., 3), f)."""
    R = sixd_to_mtx(R6D)
    Xc = xyz @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(Xc[..., 2:3], min=1e-9)
    return f * Xc[..., :2] / z + centre, Xc[..., 2]


def _residuals(R6D, t, f_eff, X_eff, uv_obs, val, centre):
    """(C, P, 3): the pixel residual where the depth is sane (z > 0.1) and
    a bounded cheirality penalty behind the camera (plain masking would
    make "everything behind the camera" a zero-cost optimum)."""
    uv_hat, z = project(X_eff, R6D, t, f_eff, centre)
    z_ok = z > 0.1
    r = torch.where(z_ok[..., None], (uv_hat - uv_obs) * val[..., None], 0.0)
    pen = 100.0 * torch.clamp(0.1 - z, min=0.0) * val
    return torch.cat([r, pen[..., None]], dim=-1)


def mini_ba(R6D0, t0, xyz, uv_obs, valid, f, centre, iters: int = 20, lm: float = 1e-4,
            optimize_focal: bool = False, optimize_pts: bool = False, huber_k: float = 5.0):
    """GN over the stacked parameters [poses (9 C), focal (1), points (3 P)].

    R6D0 (C, 3, 2), t0 (C, 3), xyz (P, 3), uv_obs (C, P, 2), valid (C, P)
    bool, f () and centre (2,).  Returns (R6D, t, f, xyz, final cost)."""
    C, P = R6D0.shape[0], xyz.shape[0]
    n_pose = 9 * C
    dim = n_pose + (1 if optimize_focal else 0) + (3 * P if optimize_pts else 0)
    val = valid.to(xyz.dtype)
    f = torch.as_tensor(f, dtype=xyz.dtype, device=xyz.device)

    def unpack(v):
        pose = v[:n_pose].reshape(C, 9)
        off = n_pose
        df = v[off] if optimize_focal else torch.zeros((), dtype=v.dtype, device=v.device)
        off += 1 if optimize_focal else 0
        dX = v[off:].reshape(P, 3) if optimize_pts else torch.zeros_like(xyz)
        return pose[:, :6].reshape(C, 3, 2), pose[:, 6:9], df, dX

    def flat_res(v):
        R6D, t, df, dX = unpack(v)
        return _residuals(R6D, t, f + df, xyz + dX, uv_obs, val, centre).reshape(-1)

    parts = [torch.cat([R6D0.reshape(C, 6), t0], dim=1).reshape(-1)]
    if optimize_focal:
        parts.append(torch.zeros(1, dtype=xyz.dtype, device=xyz.device))
    if optimize_pts:
        parts.append(torch.zeros(3 * P, dtype=xyz.dtype, device=xyz.device))
    v = torch.cat(parts)
    eye = torch.eye(dim, dtype=v.dtype, device=v.device)
    for _ in range(iters):
        r = flat_res(v)
        J = jacfwd(flat_res)(v)
        ar = torch.abs(r)
        w = torch.where(ar < huber_k, 1.0, huber_k / torch.clamp(ar, min=1e-12))
        A = J.T @ (w[:, None] * J)
        # Marquardt scaling and a clamped step keep early iterations from
        # pushing depths through zero
        A = A + lm * torch.diag(torch.diag(A)) + 1e-8 * eye
        g = J.T @ (w * r)
        dv = torch.linalg.solve(A, g)
        norm = torch.linalg.vector_norm(dv)
        v = v - dv * torch.clamp(0.5 / torch.clamp(norm, min=1e-12), max=1.0)
    R6D, t, df, dX = unpack(v)
    return R6D, t, f + df, xyz + dX, torch.sum(flat_res(v) ** 2)
