"""Trajectory evaluation: ATE/RPE with Umeyama Sim(3) alignment.

Port (a copy, numpy only) of ``artdeco_tpu/eval/trajectory.py``:
timestamp association, Umeyama alignment, APE/RPE rmse/mean/std.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from artdeco_tpu_torch.dataio.tum_io import associate_trajectories


def quat_to_R(q: np.ndarray) -> np.ndarray:
    """(N, 4) xyzw -> (N, 3, 3)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    R = np.empty((q.shape[0], 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=True):
    """Least-squares Sim(3): returns (s, R, t) with dst ~ s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _stats(err: np.ndarray) -> Dict[str, float]:
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "std": float(np.std(err)),
    }


def evaluate_ate(est_t: np.ndarray, gt_t: np.ndarray) -> Dict[str, float]:
    """Absolute trajectory error after Umeyama Sim(3) alignment."""
    s, R, t = umeyama_alignment(est_t, gt_t, with_scale=True)
    aligned = (s * (R @ est_t.T)).T + t
    return _stats(np.linalg.norm(aligned - gt_t, axis=1))


def evaluate_rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1
                 ) -> Dict[str, float]:
    """Relative pose (translation) error over ``delta``-frame steps.

    est/gt: (N, 7) [t, q xyzw].
    """
    def rel_trans(traj):
        t = traj[:, :3]
        R = quat_to_R(traj[:, 3:7])
        d = []
        for i in range(len(traj) - delta):
            dt = R[i].T @ (t[i + delta] - t[i])
            d.append(dt)
        return np.asarray(d)

    # scale-align est to gt first (monocular scale ambiguity)
    s, _, _ = umeyama_alignment(est[:, :3], gt[:, :3], with_scale=True)
    de = rel_trans(est) * s
    dg = rel_trans(gt)
    return _stats(np.linalg.norm(de - dg, axis=1))


def evaluate_trajectory(save_dir: str, out_name: str,
                        est: np.ndarray, gt: np.ndarray,
                        max_dt: float = 0.02) -> Dict:
    """Timestamp-associated ATE + RPE, JSON output
    (evaluate.py:31-104 surface).

    est/gt rows: [timestamp, tx, ty, tz, qx, qy, qz, qw].
    """
    idx = associate_trajectories(est[:, 0], gt[:, 0], max_dt=max_dt)
    ok = idx >= 0
    if ok.sum() < 3:
        result = {"error": "insufficient timestamp associations",
                  "num_poses": int(ok.sum())}
    else:
        e = est[ok, 1:8]
        g = gt[idx[ok], 1:8]
        finite = np.isfinite(g).all(axis=1)
        e, g = e[finite], g[finite]
        result = {
            "APE": _stats_block(evaluate_ate(e[:, :3], g[:, :3])),
            "RPE": _stats_block(evaluate_rpe(e, g)),
            "num_poses": int(finite.sum()),
        }
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, out_name), "w") as f:
            json.dump(result, f, indent=2)
    return result


def _stats_block(d: Dict[str, float]) -> Dict[str, float]:
    return {k: round(v, 6) for k, v in d.items()}
