"""Render turntable views of a trained run's Gaussian scene to PNG frames
and an MP4.

Port of ``scripts/visualize_gs.py``: loads a run directory written by
``run_system`` / ``SceneModel.save`` (``scene_io.load_scene_for_viewing``)
and drives ``runtime.gaussianviewer.GaussianViewer``'s turntable in splat,
depth or alpha mode on the card (``--device cpu`` runs it on the CPU).

Usage:
  python -m artdeco_tpu_torch.scripts.visualize_gs results/run1 --frames 60 --mode splat
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("run_dir", help="run output dir (contains pcd/, metadata)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--mode", default="splat", choices=["splat", "depth", "alpha"])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--out", default=None, help="output dir (default RUN_DIR/turntable)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from artdeco_tpu_torch.mapper.scene_io import load_scene_for_viewing
    from artdeco_tpu_torch.runtime.gaussianviewer import GaussianViewer

    scene = load_scene_for_viewing(args.run_dir, device=args.device)
    viewer = GaussianViewer(scene, width=args.width, height=args.height)
    out_dir = args.out or os.path.join(args.run_dir, "turntable")
    viewer.export_turntable(out_dir, n_frames=args.frames, mode=args.mode)
    print(f"wrote {args.frames} frames to {out_dir} "
          f"(make a video: python scripts/img2vid.py {out_dir})")


if __name__ == "__main__":
    main()
