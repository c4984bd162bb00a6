"""Export saved SLAM pointmaps / keyframe point clouds as viewable PLYs.

Port of ``scripts/visualize_pointmap.py``: takes a ``pts.npy`` dump
(F, H*W, 3) or (N, 3) and writes the requested frame window as one PLY.

Usage:
  python -m artdeco_tpu_torch.scripts.visualize_pointmap pts.npy --window 0 4 --out win.ply
"""

import argparse

import numpy as np


def write_xyz_ply(path: str, pts: np.ndarray, rgb: np.ndarray = None):
    from artdeco_tpu_torch.mapper.scene_io import write_ply

    fields = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [pts[:, 0], pts[:, 1], pts[:, 2]]
    if rgb is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols += [rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    write_ply(path, fields, cols)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pts", help=".npy of (F, N, 3) or (N, 3) points")
    ap.add_argument("--window", nargs=2, type=int, default=[0, 1], metavar=("LEFT", "RIGHT"),
                    help="frame window [left, right) for (F, N, 3) inputs")
    ap.add_argument("--max_dist", type=float, default=100.0,
                    help="drop points farther than this from origin")
    ap.add_argument("--stride", type=int, default=1, help="point subsampling stride")
    ap.add_argument("--out", default="pointmap.ply")
    args = ap.parse_args(argv)

    pts = np.load(args.pts, allow_pickle=True)
    pts = np.asarray(pts, np.float32).reshape(-1, 3) if pts.ndim == 2 else \
        np.asarray(pts, np.float32)
    if pts.ndim == 3:
        lo, hi = args.window
        pts = pts[lo:hi].reshape(-1, 3)
    pts = pts[:: max(args.stride, 1)]
    keep = np.linalg.norm(pts, axis=1) < args.max_dist
    pts = pts[keep]
    write_xyz_ply(args.out, pts)
    print(f"{args.out}: {len(pts)} points (range [{pts.min():.2f}, {pts.max():.2f}])")


if __name__ == "__main__":
    main()
