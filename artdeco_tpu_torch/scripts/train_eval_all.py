"""Dataset evaluation matrix on the port's entry point.

Port of ``scripts/train_eval_all.py``: the same matrix and flags, and for
each scene the same command but for the entry point, ``python -m
artdeco_tpu_torch.run_system`` where the JAX script runs ``run_system.py``
(run it from the repository's root, as the JAX script).  Per-scene
test_hold pins of record: TUM fr1_desk/fr2_xyz/fr3_long_office (30);
MipNeRF360 garden/bonsai/counter (8); StaticHikes forest1/forest2/
university2 (10).  ``--dry_run`` prints the commands.  Every scene runs
even when one fails, as in the JAX script; a failed run then makes the
script exit with 1 and name it, where the JAX script exits 0.

Usage:
  python -m artdeco_tpu_torch.scripts.train_eval_all --data_root data \\
      [--datasets tum] [--extra "--oracle"] [--dry_run]
"""

import argparse
import subprocess
import sys
from pathlib import Path

MATRIX = {
    "tum": {
        "scenes": ["rgbd_dataset_freiburg1_desk", "rgbd_dataset_freiburg2_xyz",
                   "rgbd_dataset_freiburg3_long_office_household"],
        "test_hold": 30,
        "dataset_name": "tum",
    },
    "mipnerf360": {
        "scenes": ["garden", "bonsai", "counter"],
        "test_hold": 8,
        "dataset_name": "selfCaptured",
    },
    "statichikes": {
        "scenes": ["forest1", "forest2", "university2"],
        "test_hold": 10,
        "dataset_name": "selfCaptured",
    },
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--datasets", nargs="+", default=list(MATRIX),
                    choices=list(MATRIX))
    ap.add_argument("--save_root", default="results/train_eval_all")
    ap.add_argument("--downsampling", type=float, default=2.0)
    ap.add_argument("--extra", default="")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    failed = []
    for ds in args.datasets:
        spec = MATRIX[ds]
        for scene in spec["scenes"]:
            scene_path = Path(args.data_root) / ds / scene
            out = Path(args.save_root) / ds / scene
            out.mkdir(parents=True, exist_ok=True)
            cmd = [
                sys.executable, "-m", "artdeco_tpu_torch.run_system",
                "-s", str(scene_path),
                "-d", spec["dataset_name"],
                "--test_hold", str(spec["test_hold"]),
                "--downsampling", str(args.downsampling),
                "-m", str(out),
            ] + (args.extra.split() if args.extra else [])
            print("+", " ".join(cmd), flush=True)
            if not args.dry_run:
                rc = subprocess.run(cmd).returncode
                if rc != 0:
                    failed.append(f"{ds}/{scene} (exit {rc})")
    if failed:
        raise SystemExit(f"failed runs: {', '.join(failed)}")


if __name__ == "__main__":
    main()
