"""Plain pose arithmetic for the oracle cells' check (numpy, float64).

Poses are camera-to-world [t (3), q_xyzw (4)].  A relative pose error
between frames a and b compares the program's motion T_a^-1 T_b with the
generator's exact one; its size is the distance by which the error moves
a scene point at the plane's depth ``depth``: sqrt(|dt|^2 + (depth *
angle)^2), in metres.
"""

from __future__ import annotations

import numpy as np


def quat_to_R(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def to_matrix(p: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_R(p[3:7])
    T[:3, 3] = p[:3]
    return T


def relative_error(est_a, est_b, gt_a, gt_b, depth: float) -> float:
    """The size of (gt_a^-1 gt_b)^-1 (est_a^-1 est_b), in metres at ``depth``."""
    d_est = np.linalg.inv(to_matrix(est_a)) @ to_matrix(est_b)
    d_gt = np.linalg.inv(to_matrix(gt_a)) @ to_matrix(gt_b)
    E = np.linalg.inv(d_gt) @ d_est
    angle = np.arccos(np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
    return float(np.sqrt(np.sum(E[:3, 3] ** 2) + (depth * angle) ** 2))


def worst_consecutive_error(poses: dict, gt: np.ndarray, ids, depth: float) -> float:
    """The largest relative error over consecutive entries of the sorted
    frame ids ``ids`` that ``poses`` (frame id -> pose) holds; infinite
    when fewer than two are there (nothing to compare fails)."""
    ids = sorted(i for i in ids if i in poses)
    errs = [relative_error(poses[a], poses[b], gt[a], gt[b], depth)
            for a, b in zip(ids[:-1], ids[1:])]
    return max(errs) if errs else float("inf")
