"""Export TUM poses as camera frusta PLY (port of
``scripts/tum_pose_to_ply.py``)."""

import argparse

import numpy as np


def main(argv=None):
    from artdeco_tpu_torch.dataio.tum_io import load_tum_trajectory
    from artdeco_tpu_torch.eval.trajectory import quat_to_R
    from artdeco_tpu_torch.mapper.scene_io import save_poses_as_pyramid_ply

    ap = argparse.ArgumentParser()
    ap.add_argument("traj")
    ap.add_argument("-o", "--out", default="poses.ply")
    ap.add_argument("--size", type=float, default=0.3)
    args = ap.parse_args(argv)
    t = load_tum_trajectory(args.traj)
    R = quat_to_R(t[:, 4:8])
    Rts = []
    for i in range(len(t)):
        Twc = np.eye(4)
        Twc[:3, :3] = R[i]
        Twc[:3, 3] = t[i, 1:4]
        Rts.append(np.linalg.inv(Twc))
    save_poses_as_pyramid_ply(np.asarray(Rts), args.out, size=args.size)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
