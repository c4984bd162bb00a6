"""Pose error statistics between two TUM trajectory files (port of
``scripts/compare_pose.py``)."""

import argparse


def main(argv=None):
    from artdeco_tpu_torch.dataio.tum_io import associate_trajectories, load_tum_trajectory
    from artdeco_tpu_torch.eval.trajectory import evaluate_ate, evaluate_rpe

    ap = argparse.ArgumentParser()
    ap.add_argument("traj_a")
    ap.add_argument("traj_b")
    ap.add_argument("--max_dt", type=float, default=0.02)
    args = ap.parse_args(argv)

    a = load_tum_trajectory(args.traj_a)
    b = load_tum_trajectory(args.traj_b)
    idx = associate_trajectories(a[:, 0], b[:, 0], max_dt=args.max_dt)
    ok = idx >= 0
    if ok.sum() < 3:
        raise SystemExit("insufficient timestamp associations")
    pa, pb = a[ok, 1:8], b[idx[ok], 1:8]
    print("associated poses:", int(ok.sum()))
    print("APE:", evaluate_ate(pa[:, :3], pb[:, :3]))
    print("RPE:", evaluate_rpe(pa, pb))


if __name__ == "__main__":
    main()
