"""Camera tracker: two-view Sim(3) pose optimization against the last keyframe.

Port of ``artdeco_tpu/vslam/tracker.py``.  Numerics as in the JAX package:

* The normal equations and every small matrix product of the LMs run in
  full f32 (``full_f32``): no TF32 on the card, whatever the caller set.
* A failed solve sets ``ok`` false instead of raising: the Cholesky is
  ``cholesky_ex``, and a nonzero ``info`` is folded into ``ok`` (its
  partial factor can give a finite but wrong step), as is a non-finite
  step (JAX's ``cho_factor`` yields NaN).
* Gathers by ``idx_f2k`` clamp their indices, as JAX's gathers do; the
  matcher's indices are in range by construction.

Data-dependent exits: the JAX package runs each LM as a ``while_loop``
that stops at convergence or failure.  The port runs the same iterations
in a host loop with one host sync per iteration on the stop flag: a fixed
count of 50 iterations with frozen state would cost several times more
device work than the few syncs of a typical 3-10 iteration solve.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from artdeco_tpu_torch import trace
from artdeco_tpu_torch.geometry import lie, projection as proj, robust
from artdeco_tpu_torch.geometry.uncertainty import local_diag_cov
from artdeco_tpu_torch.vslam.frame import average_conf, fuse_pointmap


class TrackingConfig(NamedTuple):
    """Static numeric knobs (config/base.yaml tracking block)."""

    min_match_frac: float = 0.05
    max_iters: int = 50
    C_conf: float = 0.0
    Q_conf: float = 1.5
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    huber: float = 1.345
    match_frac_thresh: float = 0.333
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    sigma_point: float = 0.05
    pixel_border: int = -10
    depth_eps: float = 1e-6
    # solve the LM over every point_stride-th keyframe pixel; keyframe
    # decisions and match fractions always use every pixel
    point_stride: int = 1

    @staticmethod
    def from_dict(d: dict) -> "TrackingConfig":
        fields = TrackingConfig._fields
        return TrackingConfig(**{k: v for k, v in d.items() if k in fields})


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products at full precision (no TF32) inside."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _take(x, idx):
    """x[idx] with idx clamped into range, as JAX's gathers clamp."""
    return x[idx.clamp(0, x.shape[0] - 1)]


def masked_quantile(x, mask, q: float):
    """torch.quantile-compatible (linear interpolation) over masked entries,
    without a host sync."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, big))).values
    n = mask.sum()
    pos = q * (n.to(x.dtype) - 1.0)
    last = x.shape[0] - 1
    lo = torch.floor(pos).long().clamp(0, last)
    hi = (lo + 1).clamp(0, last)
    frac = pos - lo.to(x.dtype)
    lo_v = xs.gather(0, lo.reshape(1))[0]
    hi_v = torch.where(hi < n, xs.gather(0, hi.reshape(1))[0], lo_v)
    return torch.where(n > 0, lo_v + frac * (hi_v - lo_v), torch.zeros_like(lo_v))


def _solve_gn(sqrt_info, r, J, huber_k: float):
    """Whitened + Huber-weighted normal equations.

    sqrt_info, r: (N, D); J: (N, D, M).  Returns (tau (M,), cost, ok)."""
    whitened_r = sqrt_info * r
    robust_sqrt_info = sqrt_info * torch.sqrt(robust.huber(whitened_r, k=huber_k))
    mdim = J.shape[-1]
    A = (robust_sqrt_info[..., None] * J).reshape(-1, mdim)
    b = (robust_sqrt_info * r).reshape(-1, 1)
    H = A.T @ A
    g = -(A.T @ b)
    cost = 0.5 * torch.sum(b * b)
    L, info = torch.linalg.cholesky_ex(H)
    tau = torch.cholesky_solve(g, L)[:, 0]
    ok = torch.isfinite(tau).all() & (info == 0)
    tau = torch.where(ok, tau, torch.zeros_like(tau))
    return tau, cost, ok


def _lm(step_fn, T0, max_iters: int):
    """Iterate ``step_fn(T, old_cost) -> (T', cost, done, ok_i)`` from T0
    until convergence, failure or ``max_iters``, as the JAX package's
    while_loop does.  Returns (T, ok, iterations); the iterations, each a
    host round trip, go to the ``trk.lm_iters`` counter."""
    with trace.span("trk.lm"):
        T, old_cost = T0, torch.full((), float("inf"), device=T0.device)
        ok = torch.ones((), dtype=torch.bool, device=T0.device)
        it = 0
        while it < max_iters:
            T, new_cost, done, ok_i = step_fn(T, old_cost)
            ok = ok & ok_i
            old_cost = new_cost
            it += 1
            if bool(done | ~ok):          # one host sync per iteration
                break
    trace.count("trk.lm_iters", it)
    return T, ok, it


def opt_pose_ray_dist_sim3(Xf, Xk, T_WCf, T_WCk, Qk, valid, cfg: TrackingConfig = TrackingConfig()):
    """Uncalibrated tracking: ray + distance residuals.  Returns
    (T_WCf', T_CkCf, ok)."""
    with full_f32():
        sqrt_q = torch.sqrt(Qk)
        v = valid.to(Xf.dtype)
        si_ray = (1.0 / cfg.sigma_ray) * v * sqrt_q
        si_dist = (1.0 / cfg.sigma_dist) * v * sqrt_q
        sqrt_info = torch.cat([si_ray.expand(-1, 3), si_dist], dim=1)
        rd_k = proj.point_to_ray_dist(Xk)

        def step(T, old_cost):
            Xf_Ck, dX_dT = lie.sim3_act_jac(T, Xf)
            rd_f, drd_dX = proj.point_to_ray_dist(Xf_Ck, jacobian=True)
            J = -(drd_dX @ dX_dT)
            tau, new_cost, ok_i = _solve_gn(sqrt_info, rd_k - rd_f, J, cfg.huber)
            T = lie.sim3_normalize(lie.sim3_retr(T, tau))
            done = robust.check_convergence(cfg.rel_error, cfg.delta_norm, old_cost,
                                            new_cost, tau)
            return T, new_cost, done, ok_i

        T_CkCf, ok, _ = _lm(step, lie.sim3_mul(lie.sim3_inv(T_WCk), T_WCf), cfg.max_iters)
        return lie.sim3_mul(T_WCk, T_CkCf), T_CkCf, ok


def opt_pose_calib_sim3(Xf, Xf_cov, Xk, T_WCf, T_WCk, Qk, valid, meas_k, valid_meas_k,
                        idx_f2k, K, img_size, cfg: TrackingConfig = TrackingConfig(),
                        optimize_focal: bool = False, covariance_filter: bool = False):
    """Calibrated tracking: pixel + log-depth residuals.  Returns
    (T_WCf', T_CkCf, K', ok)."""
    with full_f32():
        h, w = img_size
        dtype = Xf.dtype
        sqrt_q = torch.sqrt(Qk)
        v = valid.to(dtype)
        si_pix = (1.0 / cfg.sigma_pixel) * v * sqrt_q
        si_dep = (1.0 / cfg.sigma_depth) * v * sqrt_q
        sqrt_info = torch.cat([si_pix.expand(-1, 2), si_dep], dim=1)
        state = {"K": K}

        def step(T, old_cost):
            K_c = state["K"]
            if optimize_focal:
                uv = torch.stack([(idx_f2k % w).to(dtype), (idx_f2k // w).to(dtype)], dim=-1)
                fx, fy, cx, cy = proj.decompose_K(K_c)
                dXox = -(uv[..., 0] - cx) / (fx * fx) * Xf[..., 2]
                dXoy = -(uv[..., 1] - cy) / (fy * fy) * Xf[..., 2]
                dXf_df = torch.stack([dXox, dXoy, torch.zeros_like(dXoy)], dim=-1)[..., None]
                Xf_c = proj.backproject(uv, Xf[..., 2:3], K_c)
            else:
                Xf_c = Xf
            Xf_Ck, dX_dT = lie.sim3_act_jac(T, Xf_c)
            sR = lie.quat_to_matrix(T[3:7]) * T[7]
            dP_df = sR @ dXf_df if optimize_focal else None
            pz, dpz_dP, valid_proj = proj.project_calib(
                Xf_Ck, K_c, img_size, jacobian=True, border=cfg.pixel_border,
                z_eps=cfg.depth_eps, dP_df=dP_df)
            if covariance_filter:
                cov_w = (sR[None] * Xf_cov[:, None, :]) @ sR.T.expand(Xf_cov.shape[0], 3, 3)
                fx, fy, _, _ = proj.decompose_K(K_c)
                X_, Y_, Z_ = Xf_Ck[..., 0], Xf_Ck[..., 1], Xf_Ck[..., 2]
                Zs = torch.where(torch.abs(Z_) > 1e-12, Z_, torch.full_like(Z_, 1e-12))
                o = torch.zeros_like(X_)
                JC = torch.stack([fx / Zs, o, -fx * X_ / (Zs * Zs),
                                  o, fy / Zs, -fy * Y_ / (Zs * Zs),
                                  o, o, 1.0 / Zs], dim=-1).reshape(-1, 3, 3)
                det = torch.linalg.det(JC @ cov_w @ JC.transpose(-1, -2))
                thresh = torch.clamp_min(
                    masked_quantile(det, torch.ones_like(det, dtype=torch.bool), 0.9), 1.0)
                valid_cov = (det < thresh)[..., None]
            else:
                valid_cov = torch.ones_like(valid_meas_k)
            valid2 = valid_proj & valid_meas_k & valid_cov
            J = -dpz_dP[..., :3] @ dX_dT
            if optimize_focal:
                J = torch.cat([J, -dpz_dP[..., 3:]], dim=-1)
            tau, new_cost, ok_i = _solve_gn(valid2.to(dtype) * sqrt_info, meas_k - pz, J,
                                            cfg.huber)
            T = lie.sim3_normalize(lie.sim3_retr(T, tau[:7]))
            if optimize_focal:
                K_c = K_c.clone()
                K_c[0, 0] += tau[7]
                K_c[1, 1] += tau[7]
                state["K"] = K_c
            done = robust.check_convergence(cfg.rel_error, cfg.delta_norm, old_cost,
                                            new_cost, tau[:7])
            return T, new_cost, done, ok_i

        T_CkCf, ok, _ = _lm(step, lie.sim3_mul(lie.sim3_inv(T_WCk), T_WCf), cfg.max_iters)
        return lie.sim3_mul(T_WCk, T_CkCf), T_CkCf, state["K"], ok


# ---------------------------------------------------------------------------
# The per-frame tracking step
# ---------------------------------------------------------------------------

def track_step(Xff, Cff, fX, fC, fN, Xkf, Ckf, kX, kC, kN, idx_f2k, vmk, Qff, Qkf,
               T_WCf, T_WCk, K, last_dist, min_displacement: float, img_size: tuple,
               cfg: TrackingConfig, thres_keyframe: float = 0.8,
               optimize_focal: bool = False, covariance_filter: bool = False):
    """Everything after matching for one frame: frame pointmap fusion, the
    calibrated Sim(3) LM on every ``point_stride``-th pixel, keyframe
    pointmap fusion and the keyframe / mapper-frame tests.

    Returns (fX', fC', fN', T_WCf', T_CkCf, K', kX', kC', kN',
    flags (5,) f32 = [match_frac, ok, is_kf, is_kf_map, dist_q]); the
    caller pulls ``flags`` once."""
    with full_f32():
        idx_f2k = idx_f2k.reshape(-1)
        vmk = vmk.reshape(-1, 1)
        fX2, fC2, fN2 = fuse_pointmap(fX, fC, fN, Xff, Cff)
        favg, kavg = average_conf(fC2, fN2), average_conf(kC, kN)

        Qk = torch.sqrt(_take(Qff, idx_f2k) * Qkf)
        Xf_m, Xf_cov, Xk_m, _, Cf_m, Ck_m, meas_k, valid_meas_k = prep_track_measurements(
            fX2, kX, favg, kavg, idx_f2k, K, img_size, depth_eps=cfg.depth_eps)
        valid_opt = vmk & (Cf_m > cfg.C_conf) & (Ck_m > cfg.C_conf) & (Qk > cfg.Q_conf)
        valid_kf = vmk & (Qk > cfg.Q_conf)
        match_frac = valid_opt.float().mean()

        s = max(1, int(cfg.point_stride))
        T_WCf2, T_CkCf, K2, ok = opt_pose_calib_sim3(
            Xf_m[::s], Xf_cov[::s], Xk_m[::s], T_WCf, T_WCk, Qk[::s], valid_opt[::s],
            meas_k[::s], valid_meas_k[::s], idx_f2k[::s], K, img_size, cfg,
            optimize_focal=optimize_focal, covariance_filter=covariance_filter)
        T_WCf2 = lie.sim3_normalize(T_WCf2)

        kX2, kC2, kN2 = fuse_pointmap(kX, kC, kN, lie.sim3_act(T_CkCf, Xkf), Ckf)
        is_kf = check_keyframe(idx_f2k, valid_kf[:, 0], vmk, cfg.match_frac_thresh)
        h, w = img_size
        is_km, dq = check_keyframe_map(idx_f2k, valid_opt, w, h, thres_keyframe, last_dist,
                                       min_displacement)
        flags = torch.stack([match_frac, ok.float(), is_kf.float(), is_km.float(),
                             dq.float()])
        return fX2, fC2, fN2, T_WCf2, T_CkCf, K2, kX2, kC2, kN2, flags


# ---------------------------------------------------------------------------
# Measurement prep + keyframe decisions
# ---------------------------------------------------------------------------

def prep_track_measurements(Xf_canon, Xk_canon, Cf, Ck, idx_f2k, K, img_size,
                            depth_eps: float = 1e-6):
    """Ray-constrained points, their local covariances, the keyframe's
    pixel + log-depth measurements, gathered into keyframe pixel order."""
    h, w = img_size
    Xf = proj.constrain_points_to_ray(img_size, Xf_canon, K)
    Xk = proj.constrain_points_to_ray(img_size, Xk_canon, K)
    Xf_cov = local_diag_cov(Xf, h, w)
    Xk_cov = local_diag_cov(Xk, h, w)
    uv_k = proj.get_pixel_coords(img_size, dtype=Xf.dtype, device=Xf.device)
    valid_meas_k = Xk[..., 2:3] > depth_eps
    z_safe = torch.where(valid_meas_k, Xk[..., 2:3], torch.ones_like(Xk[..., 2:3]))
    meas_k = torch.cat([uv_k, torch.log(z_safe)], dim=-1)
    meas_k = torch.where(valid_meas_k, meas_k, torch.zeros_like(meas_k))
    return (_take(Xf, idx_f2k), _take(Xf_cov, idx_f2k), Xk, Xk_cov, _take(Cf, idx_f2k), Ck,
            meas_k, valid_meas_k)


def check_keyframe(idx_f2k, valid_kf, valid_match_k, match_frac_thresh: float):
    """New-keyframe test: min of the keyframe match fraction and the
    unique-frame-pixel fraction below the threshold (a device bool)."""
    n = valid_kf.shape[0]
    match_frac_k = valid_kf.sum() / n
    vm = valid_match_k[:, 0]
    # unique valid targets: scatter ones into n slots plus one dump slot
    # for invalid matches (out-of-range targets are dropped, as JAX drops them)
    tgt = torch.where(vm & (idx_f2k >= 0) & (idx_f2k < n), idx_f2k, torch.full_like(idx_f2k, n))
    hit = torch.zeros(n + 1, dtype=torch.int32, device=idx_f2k.device)
    hit[tgt.long()] = 1
    unique_frac_f = hit[:n].sum() / n
    return torch.minimum(match_frac_k, unique_frac_f) < match_frac_thresh


def check_keyframe_map(idx_f2k, valid_opt, W: int, H: int, q: float, last_dist,
                       min_displacement: float):
    """Mapper-frame test: the q-quantile of the displacement between
    matched and source pixels, against the last mapper frame's."""
    uf = (idx_f2k % W).float()
    vf = (idx_f2k // W).float()
    uv = proj.get_pixel_coords((H, W), device=idx_f2k.device)
    dist = torch.sqrt((uf - uv[:, 0]) ** 2 + (vf - uv[:, 1]) ** 2)
    dq = masked_quantile(dist, valid_opt[:, 0], q)
    return (dq - last_dist) > min_displacement, dq
