"""Batched PnP by Levenberg-Marquardt over se(3).

Port of ``artdeco_tpu/poses/pnp.py``: Huber-weighted reprojection
residuals, their Jacobian with respect to a left se(3) perturbation, a
damped 6x6 solve per batch element and the left retraction (Sim(3) at
unit scale).  The JAX package's ``vmap`` is the batch dimension here.
"""

from __future__ import annotations

import torch

from artdeco_tpu_torch.geometry import lie


def pnp_residual_jac(T_cw, X, uv, K):
    """Reprojection residuals (B, P, 2) and their Jacobian (B, P, 2, 6)
    with respect to a left se(3) perturbation.  T_cw (B, 7) [t, q xyzw],
    X (B, P, 3) world points, uv (B, P, 2), K (3, 3)."""
    Xc = lie.se3_act(T_cw, X)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z_inv = 1.0 / torch.clamp(Xc[..., 2], min=1e-9)
    x, y = Xc[..., 0], Xc[..., 1]
    r = torch.stack([fx * x * z_inv + cx, fy * y * z_inv + cy], dim=-1) - uv
    zeros = torch.zeros_like(z_inv)
    # d(uv)/dXc, chained with dXc/dxi = [I, -skew(Xc)]
    du = torch.stack([fx * z_inv, zeros, -fx * x * z_inv * z_inv], dim=-1)
    dv = torch.stack([zeros, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1)
    dP = torch.stack([du, dv], dim=-2)                     # (B, P, 2, 3)
    sk = torch.stack([
        torch.stack([zeros, Xc[..., 2], -Xc[..., 1]], -1),
        torch.stack([-Xc[..., 2], zeros, Xc[..., 0]], -1),
        torch.stack([Xc[..., 1], -Xc[..., 0], zeros], -1),
    ], dim=-2)                                             # -skew(Xc)
    return r, torch.cat([dP, dP @ sk], dim=-1)


def opt_pnp(T0_cw, X, uv, valid, K, iters: int = 20, lm: float = 1e-4,
            huber_k: float = 3.0):
    """Batched PnP: T0_cw (B, 7) initial world -> cam, X (B, P, 3), uv
    (B, P, 2), valid (B, P) bool, K (3, 3).  Returns (T_cw (B, 7), final
    cost (B,))."""
    vb = valid.to(X.dtype)
    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    T = T0_cw
    for _ in range(iters):
        r, J = pnp_residual_jac(T, X, uv, K)
        ar = torch.abs(r)
        w = torch.where(ar < huber_k, 1.0, huber_k / torch.clamp(ar, min=1e-12)) * vb[..., None]
        Jw = w[..., None] * J
        H = torch.einsum("bprc,bprd->bcd", Jw, J) + lm * eye
        g = torch.einsum("bprc,bpr->bc", Jw, r)
        dx = -torch.linalg.solve(H, g)
        # left-multiplicative SE(3) retraction through Sim(3) at unit scale
        T8 = torch.cat([T, torch.ones_like(T[:, :1])], dim=-1)
        xi = torch.cat([dx, torch.zeros_like(dx[:, :1])], dim=-1)
        T = lie.sim3_normalize(lie.sim3_retr(T8, xi))[:, :7]
    r, _ = pnp_residual_jac(T, X, uv, K)
    return T, torch.sum((r * vb[..., None]) ** 2, dim=(1, 2))
