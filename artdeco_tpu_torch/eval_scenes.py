"""Batch evaluation harness of the port: run the entry point over a setup x
scene matrix, then scrape each run's metadata.

    python -m artdeco_tpu_torch.eval_scenes --scenes /data/tum/fr1_desk /data/garden \
        --setups onthefly covfilter --downsampling 2 --save_root results/

Port of the root ``eval_scenes.py``: the same named setups and flags, each
run a ``python -m artdeco_tpu_torch.run_system`` process, and the same
``metadata.json`` / ``run_metadata.json`` scraped into
``<save_root>/summary.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List


@dataclass
class Setup:
    name: str
    base_args: List[str] = field(default_factory=list)
    apply_calibration: bool = True

    def get_args(self) -> List[str]:
        return list(self.base_args)


SETUPS = {
    "onthefly": Setup("onthefly", []),
    "covfilter": Setup("covfilter", ["--covariance_filter", "--point_fusion_frontend"]),
    "accurate-lc": Setup("accurate-lc", ["--covariance_filter", "--point_fusion_frontend",
                                         "--accurate_loop_closure"]),
    "oracle": Setup("oracle", ["--oracle", "-d", "synthetic"], apply_calibration=False),
}


def build_cmd(python, scene, setup: Setup, args, save_dir):
    """The entry point's command line for one scene under one setup."""
    base = [
        python, "-m", "artdeco_tpu_torch.run_system",
        "-s", str(scene),
        "--images_dir", args.images_dir,
        "--config", args.config,
        "--downsampling", str(args.downsampling),
        "--test_hold", str(args.test_hold),
        "-m", str(save_dir),
    ]
    if setup.apply_calibration and args.calib:
        base += ["--calib", args.calib]
    base += setup.get_args()
    if args.extra:
        base += args.extra.split()
    return base


def scrape_metrics(save_dir: Path) -> dict:
    out = {}
    for name in ("metadata.json", "run_metadata.json"):
        p = save_dir / name
        if p.is_file():
            out[name] = json.loads(p.read_text())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--setups", nargs="+", default=["onthefly"], choices=list(SETUPS))
    ap.add_argument("--images_dir", default="images")
    ap.add_argument("--config", default="config/base.yaml")
    ap.add_argument("--calib", default=None)
    ap.add_argument("--downsampling", type=float, default=2.0)
    ap.add_argument("--test_hold", type=int, default=8)
    ap.add_argument("--save_root", default="results")
    ap.add_argument("--extra", default="")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    summary = {}
    for setup_name in args.setups:
        setup = SETUPS[setup_name]
        for scene in args.scenes:
            scene_name = Path(scene.rstrip("/")).name or "synthetic"
            save_dir = Path(args.save_root) / setup_name / scene_name
            save_dir.mkdir(parents=True, exist_ok=True)
            cmd = build_cmd(sys.executable, scene, setup, args, save_dir)
            print("+", " ".join(cmd))
            if args.dry_run:
                continue
            ret = subprocess.run(cmd).returncode
            if ret != 0:
                print(f"FAILED: {setup_name}/{scene_name} (exit {ret})")
                continue
            summary[f"{setup_name}/{scene_name}"] = scrape_metrics(save_dir)

    out = Path(args.save_root) / "summary.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2, default=str))
    print(f"wrote {out}")
    return summary


if __name__ == "__main__":
    main()
