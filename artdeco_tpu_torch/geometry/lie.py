"""Sim(3) / SE(3) / SO(3) Lie-group operations in PyTorch.

Port of ``artdeco_tpu/geometry/lie.py`` with the same conventions:

* A Sim(3) element is an 8-vector ``[tx, ty, tz, qx, qy, qz, qw, s]``.
* An SE(3) element is a 7-vector ``[tx, ty, tz, qx, qy, qz, qw]``.
* The Sim(3) tangent is a 7-vector ``xi = [tau(3), phi(3), sigma]``.
* Action: ``Y = s * R(q) * X + t``; retraction is left-multiplicative,
  ``retr(T, xi) = Exp(xi) * T``; the action Jacobian wrt a left
  perturbation is ``[I, -skew(Y), Y]`` (3x7).

All functions broadcast over leading batch dimensions.  ``torch.where``
evaluates both of its branches, so every branch here is fed "safe" inputs
(a divisor replaced by 1 where the other branch is selected): the branch
that is not selected stays finite, as in the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (xyzw)
# ---------------------------------------------------------------------------

def quat_mul(qi, qj):
    """Hamilton product ``qi * qj`` for xyzw quaternions."""
    xi, yi, zi, wi = qi.unbind(-1)
    xj, yj, zj, wj = qj.unbind(-1)
    return torch.stack([
        wi * xj + xi * wj + yi * zj - zi * yj,
        wi * yj - xi * zj + yi * wj + zi * xj,
        wi * zj + xi * yj - yi * xj + zi * wj,
        wi * wj - xi * xj - yi * yj - zi * zj,
    ], dim=-1)


def quat_inv(q):
    """Conjugate of a unit quaternion."""
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_act(q, x):
    """Rotate vector(s) ``x`` by unit quaternion ``q``."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, x)
    return x + qw * uv + _cross(qv, uv)


def quat_to_matrix(q):
    """Unit quaternion (xyzw) -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """3x3 rotation matrix -> unit quaternion (xyzw). Branch-free Shepperd:
    four candidate constructions, the one with the largest pivot wins."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(piv_sq, vals, k):
        p = torch.sqrt(torch.clamp_min(piv_sq, 0.0)) / 2
        q = torch.stack(vals(4 * p * p), -1) / torch.clamp_min(4 * p, _EPS)[..., None]
        return torch.cat([q[..., :k], p[..., None], q[..., k + 1:]], dim=-1)

    q0 = cand(1.0 + tr, lambda s: [m21 - m12, m02 - m20, m10 - m01, s], 3)
    q1 = cand(1.0 + m00 - m11 - m22, lambda s: [s, m01 + m10, m02 + m20, m21 - m12], 0)
    q2 = cand(1.0 - m00 + m11 - m22, lambda s: [m01 + m10, s, m12 + m21, m02 - m20], 1)
    q3 = cand(1.0 - m00 - m11 + m22, lambda s: [m02 + m20, m12 + m21, s, m10 - m01], 2)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.take_along_dim(qs, best[..., None, None].expand(best.shape + (1, 4)),
                             dim=-2).squeeze(-2)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_exp(phi):
    """so(3) 3-vector -> unit quaternion (Taylor branch near 0)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < _EPS
    imag_small = 0.5 - theta_sq / 48.0 + theta_p4 / 3840.0
    real_small = 1.0 - theta_sq / 8.0 + theta_p4 / 384.0
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    imag_big = torch.sin(0.5 * theta) / theta_safe
    real_big = torch.cos(0.5 * theta)
    imag = torch.where(small, imag_small, imag_big)
    real = torch.where(small, real_small, real_big)
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q):
    """Unit quaternion -> so(3) 3-vector."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw < 0, -torch.ones_like(qw), torch.ones_like(qw))
    qv, qw = qv * sign, qw * sign
    norm_v = torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    small = norm_v < _EPS
    norm_v_safe = torch.where(small, torch.ones_like(norm_v), norm_v)
    qw_c = torch.clamp(qw, -1.0, 1.0)
    theta = 2.0 * torch.atan2(norm_v, qw_c)
    scale_small = 2.0 / torch.clamp_min(qw_c, _EPS)
    scale = torch.where(small, scale_small, theta / norm_v_safe)
    return scale * qv


def skew(x):
    """3-vector(s) -> skew-symmetric matrix."""
    o = torch.zeros_like(x[..., 0])
    xx, yy, zz = x[..., 0], x[..., 1], x[..., 2]
    m = torch.stack([o, -zz, yy, zz, o, -xx, -yy, xx, o], dim=-1)
    return m.reshape(x.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3_identity(batch_shape=(), dtype=torch.float32, *, device):
    e = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return e.expand(tuple(batch_shape) + (8,)).clone()


def sim3_normalize(T):
    """Re-normalize the quaternion part."""
    return torch.cat([T[..., 0:3], quat_normalize(T[..., 3:7]), T[..., 7:8]], dim=-1)


def sim3_act(T, X):
    """``Y = s R X + t``; T (..., 8) against X (..., N, 3) or (..., 3)."""
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    if X.dim() > T.dim():
        t, q, s = t[..., None, :], q[..., None, :], s[..., None, :]
    return s * quat_act(q, X) + t


def sim3_act_jac(T, X):
    """Action + 3x7 Jacobian wrt a LEFT perturbation [tau, phi, sigma].
    Returns (Y (..., 3), J (..., 3, 7))."""
    Y = sim3_act(T, X)
    eye = torch.eye(3, dtype=Y.dtype, device=Y.device).expand(Y.shape[:-1] + (3, 3))
    J = torch.cat([eye, -skew(Y), Y[..., :, None]], dim=-1)
    return Y, J


def sim3_inv(T):
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    q_inv = quat_inv(q)
    s_inv = 1.0 / s
    t_inv = -s_inv * quat_act(q_inv, t)
    return torch.cat([t_inv, q_inv, s_inv], dim=-1)


def sim3_mul(Ti, Tj):
    """Composition ``Ti * Tj`` (first apply Tj, then Ti)."""
    ti, qi, si = Ti[..., 0:3], Ti[..., 3:7], Ti[..., 7:8]
    tj, qj, sj = Tj[..., 0:3], Tj[..., 3:7], Tj[..., 7:8]
    q = quat_mul(qi, qj)
    s = si * sj
    t = si * quat_act(qi, tj) + ti
    return torch.cat([t, q, s], dim=-1)


def sim3_rel(Ti, Tj):
    """``Ti^-1 * Tj``."""
    return sim3_mul(sim3_inv(Ti), Tj)


def _sim3_W_coeffs(theta_sq, sigma):
    """Coefficients (C, A, B) of W = C I + A Phi + B Phi^2, where
    W = integral_0^1 e^{sigma s} exp(s Phi) ds.  expm1 plus wide Taylor
    branches (|sigma| < 0.1, theta < 1e-2) keep every branch well
    conditioned in f32, as in the JAX package.  All inputs (..., 1)."""
    one = torch.ones_like(sigma)
    theta = torch.sqrt(theta_sq)
    m = torch.expm1(sigma)
    scale = 1.0 + m

    small_sigma = torch.abs(sigma) < 0.1
    small_theta = theta < 1e-2

    sigma_safe = torch.where(small_sigma, one, sigma)
    theta_safe = torch.where(small_theta, torch.ones_like(theta), theta)
    theta_sq_safe = torch.where(small_theta, torch.ones_like(theta_sq), theta_sq)

    C_series = 1.0 + sigma * (0.5 + sigma * (1.0 / 6.0 + sigma / 24.0))
    C = torch.where(small_sigma, C_series, m / sigma_safe)

    A_st_series = 0.5 + sigma * (1.0 / 3.0 + sigma * (1.0 / 8.0 + sigma / 30.0))
    B_st_series = 1.0 / 6.0 + sigma * (1.0 / 8.0 + sigma * (1.0 / 20.0 + sigma / 72.0))
    A_st_exact = (sigma - m + sigma * m) / (sigma_safe * sigma_safe)
    B_st_exact = ((m - sigma) + 0.5 * sigma * sigma * scale - sigma * m) / (
        sigma_safe * sigma_safe * sigma_safe)
    A_st = torch.where(small_sigma, A_st_series, A_st_exact)
    B_st = torch.where(small_sigma, B_st_series, B_st_exact)

    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    half_sin = torch.sin(0.5 * theta)
    one_minus_b = 2.0 * half_sin * half_sin - cos_t * m  # 1 - e^sigma cos(theta)
    a_ = scale * sin_t
    c = theta_sq + sigma * sigma
    c_safe = torch.where(small_theta, torch.ones_like(c), c)
    A_lt = (a_ * sigma + one_minus_b * theta) / (theta_safe * c_safe)
    B_lt = (C - (-one_minus_b * sigma + a_ * theta) / c_safe) / theta_sq_safe

    A = torch.where(small_theta, A_st, A_lt)
    B = torch.where(small_theta, B_st, B_lt)
    return C, A, B


def sim3_exp(xi):
    """sim(3) 7-vector [tau, phi, sigma] -> Sim(3) 8-vector."""
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6:7]
    q = so3_exp(phi)
    s = torch.exp(sigma)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    C, A, B = _sim3_W_coeffs(theta_sq, sigma)
    phi_x_tau = _cross(phi, tau)
    phi_x2_tau = _cross(phi, phi_x_tau)
    t = C * tau + A * phi_x_tau + B * phi_x2_tau
    return torch.cat([t, q, s], dim=-1)


def sim3_log(T):
    """Sim(3) 8-vector -> sim(3) 7-vector. Inverse of sim3_exp."""
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    phi = so3_log(q)
    sigma = torch.log(s)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    C, A, B = _sim3_W_coeffs(theta_sq, sigma)
    Phi = skew(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(Phi.shape)
    W = C[..., None] * eye + A[..., None] * Phi + B[..., None] * (Phi @ Phi)
    tau = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def sim3_retr(T, xi):
    """Left-multiplicative retraction ``Exp(xi) * T``."""
    return sim3_mul(sim3_exp(xi), T)


def _homogeneous(top):
    bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def sim3_matrix(T):
    """Sim(3) -> 4x4 homogeneous matrix with sR upper block."""
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    R = quat_to_matrix(q) * s[..., None]
    return _homogeneous(torch.cat([R, t[..., None]], dim=-1))


def sim3_from_matrix(M):
    """4x4 homogeneous (sR | t) -> Sim(3) 8-vector."""
    sR = M[..., :3, :3]
    s = torch.linalg.det(sR)[..., None] ** (1.0 / 3.0)
    R = sR / s[..., None]
    q = matrix_to_quat(R)
    t = M[..., :3, 3]
    return torch.cat([t, q, s], dim=-1)


def sim3_adj_inv_transpose_apply(T, X):
    """``Y = Adj(T)^{-T} X`` on tangent row-vectors."""
    t, q, s = T[..., 0:3], T[..., 3:7], T[..., 7:8]
    s_inv = 1.0 / s
    a, b, c = X[..., 0:3], X[..., 3:6], X[..., 6:7]
    Ra = quat_act(q, a)
    y0 = s_inv * Ra
    y1 = quat_act(q, b) + s_inv * _cross(t, Ra)
    y2 = c + s_inv * torch.sum(t * Ra, dim=-1, keepdim=True)
    return torch.cat([y0, y1, y2], dim=-1)


# ---------------------------------------------------------------------------
# SE(3) (7-vector [t, q])
# ---------------------------------------------------------------------------

def se3_identity(batch_shape=(), dtype=torch.float32, *, device):
    e = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return e.expand(tuple(batch_shape) + (7,)).clone()


def se3_act(T, X):
    t, q = T[..., 0:3], T[..., 3:7]
    if X.dim() > T.dim():
        t, q = t[..., None, :], q[..., None, :]
    return quat_act(q, X) + t


def se3_inv(T):
    t, q = T[..., 0:3], T[..., 3:7]
    q_inv = quat_inv(q)
    return torch.cat([-quat_act(q_inv, t), q_inv], dim=-1)


def se3_mul(Ti, Tj):
    ti, qi = Ti[..., 0:3], Ti[..., 3:7]
    tj, qj = Tj[..., 0:3], Tj[..., 3:7]
    return torch.cat([quat_act(qi, tj) + ti, quat_mul(qi, qj)], dim=-1)


def se3_matrix(T):
    t, q = T[..., 0:3], T[..., 3:7]
    return _homogeneous(torch.cat([quat_to_matrix(q), t[..., None]], dim=-1))


def se3_from_matrix(M):
    return torch.cat([M[..., :3, 3], matrix_to_quat(M[..., :3, :3])], dim=-1)


def sim3_to_se3(T):
    """Drop the scale (used when exporting trajectories)."""
    return T[..., 0:7]
