"""Export a TUM trajectory as a PLY polyline (port of ``scripts/traj.py``)."""

import argparse

import numpy as np


def main(argv=None):
    from artdeco_tpu_torch.dataio.tum_io import load_tum_trajectory
    from artdeco_tpu_torch.mapper.scene_io import write_ply

    ap = argparse.ArgumentParser()
    ap.add_argument("traj")
    ap.add_argument("-o", "--out", default="traj.ply")
    args = ap.parse_args(argv)
    t = load_tum_trajectory(args.traj)
    xyz = t[:, 1:4].astype(np.float32)
    n = len(xyz)
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4"),
              ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    c = np.linspace(0, 255, n).astype(np.uint8)
    write_ply(args.out, fields, [xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                 c, 255 - c, np.zeros(n, np.uint8)])
    print(f"wrote {args.out} ({n} points)")


if __name__ == "__main__":
    main()
