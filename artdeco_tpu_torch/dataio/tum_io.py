"""TUM trajectory IO + timestamp association.

Port (a copy, numpy only) of ``artdeco_tpu/dataio/tum_io.py``.
"""

from __future__ import annotations

import numpy as np


def load_tum_trajectory(path: str) -> np.ndarray:
    """Load 'timestamp tx ty tz qx qy qz qw' rows -> (N, 8)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    return np.asarray(rows, np.float64)


def save_tum_trajectory(path: str, timestamps, poses) -> None:
    """poses (N, 7) [tx ty tz qx qy qz qw]."""
    with open(path, "w") as f:
        for t, p in zip(timestamps, poses):
            f.write(
                f"{t} " + " ".join(f"{float(x):.8f}" for x in p[:7]) + "\n"
            )


def associate_trajectories(ts_a: np.ndarray, ts_b: np.ndarray,
                           max_dt: float = 0.02) -> np.ndarray:
    """For each a-timestamp, index of the nearest b-timestamp within max_dt
    (-1 if none)."""
    order = np.argsort(ts_b)
    tsb = ts_b[order]
    pos = np.searchsorted(tsb, ts_a)
    out = np.full(ts_a.shape, -1, np.int64)
    for i, p in enumerate(pos):
        best, bd = -1, max_dt
        for cand in (p - 1, p):
            if 0 <= cand < len(tsb):
                d = abs(tsb[cand] - ts_a[i])
                if d <= bd:
                    best, bd = order[cand], d
        out[i] = best
    return out
