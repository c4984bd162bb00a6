"""Inter-frame ground-truth pose statistics for dataset vetting.

Port of ``scripts/scannetpp_check.py``: before running a scene,
sanity-check how large the frame-to-frame motion is (mean/max relative
translation and rotation angle): sequences with multi-degree jumps between
consecutive frames will lose tracking and need resampling.

Accepts either a ``scene_metadata.npz`` tree (keys ``trajectories`` (N,4,4)
and ``images``) or any dataset our loaders understand (COLMAP / TUM /
selfCaptured) via ``--dataset``.

Usage:
  python -m artdeco_tpu_torch.scripts.scannetpp_check /path/with/scene_metadata.npz-trees
  python -m artdeco_tpu_torch.scripts.scannetpp_check -s /path/to/scene -d tum [-o out.json]
"""

import argparse
import json
import os

import numpy as np


def pair_stats(poses: np.ndarray, skip_tail: int = 0):
    """poses: (N, 4, 4) cam->world.  Returns per-pair translation norms and
    rotation angles (degrees) of T_rel = inv(T_i) @ T_{i+1}."""
    translations, angles = [], []
    n = len(poses) - 1 - skip_tail
    for i in range(max(n, 0)):
        a, b = poses[i], poses[i + 1]
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            continue
        T_rel = np.linalg.inv(a) @ b
        translations.append(float(np.linalg.norm(T_rel[:3, 3])))
        c = (np.trace(T_rel[:3, :3]) - 1.0) / 2.0
        angles.append(float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))
    return np.asarray(translations), np.asarray(angles)


def stats_dict(translations, angles):
    if len(angles) == 0:
        return dict(mean_angle=0.0, max_angle=0.0,
                    mean_translation=0.0, max_translation=0.0)
    return dict(
        mean_angle=float(np.mean(angles)),
        max_angle=float(np.max(angles)),
        mean_translation=float(np.mean(translations)),
        max_translation=float(np.max(translations)),
    )


def scan_metadata_trees(root: str, skip_tail: int):
    results = {}
    for sub in sorted(os.listdir(root)):
        meta = os.path.join(root, sub, "scene_metadata.npz")
        if not os.path.isfile(meta):
            continue
        data = np.load(meta, allow_pickle=True)
        poses = np.asarray(data["trajectories"], np.float64)
        if "images" in data:
            order = np.argsort([str(x) for x in data["images"]])
            poses = poses[order]
        t, a = pair_stats(poses, skip_tail)
        results[sub] = stats_dict(t, a)
        print(sub, results[sub])
    return results


def scan_dataset(args):
    import torch

    from artdeco_tpu_torch.dataio.dataset import load_dataset
    from artdeco_tpu_torch.geometry import lie

    dataset = load_dataset(args)
    if dataset.Twc_gt is None:
        raise SystemExit("dataset has no ground-truth trajectory")
    mats = np.stack([
        lie.se3_matrix(torch.as_tensor(np.asarray(T[:7], np.float32))).numpy()
        for T in dataset.Twc_gt
    ])
    t, a = pair_stats(mats, 0)
    res = stats_dict(t, a)
    print(json.dumps(res, indent=2))
    return {os.path.basename(args.source_path or "."): res}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", help="dir of scene_metadata.npz trees")
    ap.add_argument("-s", "--source_path", default="")
    ap.add_argument("-i", "--images_dir", default="images")
    ap.add_argument("-d", "--dataset_name", default="tum")
    ap.add_argument("-o", "--output", default="")
    ap.add_argument("--skip_tail", type=int, default=50,
                    help="trailing frames to ignore (reference end_at)")
    # loader pass-throughs
    ap.add_argument("--downsampling", type=float, default=2.0)
    ap.add_argument("--max_size_slam", type=int, default=512)
    ap.add_argument("--test_hold", type=int, default=-1)
    ap.add_argument("--start_at", type=int, default=0)
    ap.add_argument("--end_at", type=int, default=0)
    ap.add_argument("--seq_length", type=int, default=0)
    ap.add_argument("--image_sampling", type=int, default=0)
    ap.add_argument("--calib", default=None)
    ap.add_argument("--init_focal", type=float, default=-1.0)
    ap.add_argument("--init_fov", type=float, default=-1.0)
    args = ap.parse_args(argv)

    if args.root:
        results = scan_metadata_trees(args.root, args.skip_tail)
    elif args.source_path:
        results = scan_dataset(args)
    else:
        ap.error("give a metadata root or -s/--source_path")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=4)


if __name__ == "__main__":
    main()
