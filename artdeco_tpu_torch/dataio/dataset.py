"""Datasets: image-folder streaming with calibration + test-split marking.

Host copy (numpy) of ``artdeco_tpu/dataio/dataset.py``: ``BaseDataset``,
the image-folder (``SelfCapturedDataset``), TUM RGB-D (``TUMDataset``)
and COLMAP (``ColmapDataset``) datasets, the procedural
``SyntheticDataset``, and the ``load_dataset`` factory with its COLMAP
auto-detect.  Calibration comes from a YAML file (``--calib``), a COLMAP
model, ``--init_focal`` / ``--init_fov``, or the 0.7 * W guess that
``System`` may replace by a focal estimated from the first frame
(``calib_is_guess``, ``recalibrate_focal``).  Frames are decoded without
OpenCV (``image_io.load_image``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import yaml

from artdeco_tpu_torch.dataio.camera import PinholeCamera
from artdeco_tpu_torch.dataio.image_io import load_image

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class BaseDataset:
    """Requires subclasses to set image_dir, image_name_list, timestamp,
    and optionally Twc_gt before calling ``_finish_init``."""

    image_dir: str
    image_name_list: list
    timestamp: list
    Twc_gt: Optional[np.ndarray] = None

    def _finish_init(self, args):
        assert len(self.image_name_list) == len(self.timestamp)
        if getattr(args, "image_sampling", 0) > 1:
            s = args.image_sampling
            self.image_name_list = self.image_name_list[::s]
            self.timestamp = self.timestamp[::s]
            if self.Twc_gt is not None:
                self.Twc_gt = self.Twc_gt[::s]
        start = getattr(args, "start_at", 0)
        end = len(self.image_name_list) - getattr(args, "end_at", 0)
        self.image_name_list = self.image_name_list[start:end]
        self.timestamp = self.timestamp[start:end]
        if self.Twc_gt is not None:
            self.Twc_gt = self.Twc_gt[start:end]
        seq_len = getattr(args, "seq_length", 0)
        if seq_len > 0:
            self.image_name_list = self.image_name_list[:seq_len]
            self.timestamp = self.timestamp[:seq_len]
            if self.Twc_gt is not None:
                self.Twc_gt = self.Twc_gt[:seq_len]

        self.image_paths = [os.path.join(self.image_dir, n) for n in self.image_name_list]
        if not self.image_paths:
            raise FileNotFoundError(f"No images found in {self.image_dir}")

        test_hold = getattr(args, "test_hold", -1)
        self.infos = {
            name: {
                "is_test": (test_hold > 0) and (i % test_hold == 0) and i != 0,
                "name": name,
                "timestamp": self.timestamp[i],
            }
            for i, name in enumerate(self.image_name_list)
        }

        # calibration
        self.calib_is_guess = False
        calib_path = getattr(args, "calib", None)
        if calib_path:
            with open(calib_path) as f:
                intrinsics = yaml.safe_load(f)
        elif getattr(self, "_forced_intrinsics", None) is not None:
            intrinsics = self._forced_intrinsics
        else:
            H, W = self._probe_size()
            fov = getattr(args, "init_fov", -1.0)
            focal = getattr(args, "init_focal", -1.0)
            if focal <= 0:
                if fov > 0:
                    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(fov))
                else:
                    focal = 0.7 * W  # ~71 deg horizontal default guess
                    # flag for model-based auto-calibration (System)
                    self.calib_is_guess = True
            intrinsics = {"width": W, "height": H, "calibration": [focal, focal, W / 2, H / 2]}
        self.downsampling = getattr(args, "downsampling", 1.0)
        self.load_calib(intrinsics, getattr(args, "max_size_slam", 512),
                        getattr(args, "optimize_focal", False))
        self.current_index = 0

    def _probe_size(self) -> Tuple[int, int]:
        img = self._load_image(self.image_paths[0])
        return img.shape[0], img.shape[1]

    def load_calib(self, intrinsics, max_size_slam=512, optimize_focal=False):
        self._max_size_slam = max_size_slam
        self._optimize_focal = optimize_focal
        self.transform = PinholeCamera(
            max_size_slam, self.downsampling, intrinsics["width"], intrinsics["height"],
            intrinsics["calibration"], optimize_focal=optimize_focal,
        )
        self.H, self.W = intrinsics["height"], intrinsics["width"]
        self.H_slam, self.W_slam = self.transform.H_slam, self.transform.W_slam
        self.H_map, self.W_map = self.transform.H_map, self.transform.W_map
        self.K_slam = self.transform.K_slam
        self.K_map = self.transform.K_map

    def recalibrate_focal(self, focal: float):
        """Replace the focal guess with an estimated value (original-image
        pixels) and rebuild the dual-resolution transforms (the model-based
        auto-calibration of ``System``)."""
        intrinsics = {
            "width": self.W, "height": self.H,
            "calibration": [float(focal), float(focal), self.W / 2, self.H / 2],
        }
        self.load_calib(intrinsics, max_size_slam=self._max_size_slam,
                        optimize_focal=self._optimize_focal)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index) -> Tuple[np.ndarray, Dict[str, Any]]:
        image = self._load_image(self.image_paths[index])
        # by the listed name: a TUM frame's is its path under the root
        # (the JAX package looks up the basename there, a KeyError)
        info = dict(self.infos[self.image_name_list[index]])
        if self.Twc_gt is not None:
            info["Twc_gt"] = self.Twc_gt[index]
        return image, info

    @staticmethod
    def _load_image(path: str) -> np.ndarray:
        return load_image(path)

    def getnext(self):
        out = self[self.current_index]
        self.current_index += 1
        return out

    def get_image_size(self):
        return self.H_map, self.W_map


class SelfCapturedDataset(BaseDataset):
    """Image folder + optional TUM-format gt poses
    (the reference's ``DatasetSelfCaptured.py:27-47``)."""

    def __init__(self, args):
        self.image_dir = os.path.join(args.source_path, args.images_dir)
        names = sorted(n for n in os.listdir(self.image_dir) if n.lower().endswith(IMAGE_EXTS))
        self.image_name_list = names
        self.timestamp = list(np.arange(len(names), dtype=np.float64))
        self.Twc_gt = None
        gt_file = os.path.join(args.source_path, "groundtruth.txt")
        if os.path.isfile(gt_file):
            from artdeco_tpu_torch.dataio.tum_io import load_tum_trajectory

            traj = load_tum_trajectory(gt_file)
            if len(traj) == len(names):
                self.timestamp = traj[:, 0].tolist()
                self.Twc_gt = traj[:, 1:8]
        self._finish_init(args)


class TUMDataset(BaseDataset):
    """TUM RGB-D: rgb.txt index + groundtruth.txt association."""

    def __init__(self, args):
        root = args.source_path
        entries = []
        with open(os.path.join(root, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                entries.append((float(ts), rel))
        self.image_dir = root
        self.image_name_list = [rel for _, rel in entries]
        self.timestamp = [ts for ts, _ in entries]
        self.Twc_gt = None
        gt_file = os.path.join(root, "groundtruth.txt")
        if os.path.isfile(gt_file):
            from artdeco_tpu_torch.dataio.tum_io import (
                associate_trajectories, load_tum_trajectory,
            )

            gt = load_tum_trajectory(gt_file)
            idx = associate_trajectories(np.asarray(self.timestamp), gt[:, 0], max_dt=0.05)
            poses = np.full((len(self.timestamp), 7), np.nan)
            ok = idx >= 0
            poses[ok] = gt[idx[ok], 1:8]
            if ok.any():
                self.Twc_gt = poses
        self._finish_init(args)


class ColmapDataset(BaseDataset):
    """Image folder calibrated by a COLMAP model (sparse/0), the layout of
    the MipNeRF360-class scenes.  Intrinsics come from the first camera;
    GT world->cam poses from images.bin are inverted into Twc and matched
    to the image list by name."""

    # COLMAP camera models: id -> name (param layout)
    _MODELS = {
        0: "SIMPLE_PINHOLE",   # f, cx, cy
        1: "PINHOLE",          # fx, fy, cx, cy
        2: "SIMPLE_RADIAL",    # f, cx, cy, k1
        3: "RADIAL",           # f, cx, cy, k1, k2
        4: "OPENCV",           # fx, fy, cx, cy, k1, k2, p1, p2
    }

    def __init__(self, args):
        from artdeco_tpu_torch.mapper.scene_io import read_colmap_model

        root = args.source_path
        model_dir = None
        for cand in ("sparse/0", "sparse", "colmap/sparse/0"):
            d = os.path.join(root, cand)
            if os.path.isfile(os.path.join(d, "cameras.bin")):
                model_dir = d
                break
        if model_dir is None:
            raise FileNotFoundError(f"no COLMAP model (cameras.bin) under {root}/sparse[/0]")
        cameras, images = read_colmap_model(model_dir)

        self.image_dir = os.path.join(root, args.images_dir)
        names = sorted(n for n in os.listdir(self.image_dir) if n.lower().endswith(IMAGE_EXTS))
        self.image_name_list = names
        self.timestamp = list(np.arange(len(names), dtype=np.float64))

        # GT poses by image name: COLMAP stores world->cam (qw qx qy qz, t)
        by_name = {im["name"]: im for im in images.values()}
        poses = np.full((len(names), 7), np.nan)
        for i, n in enumerate(names):
            im = by_name.get(n)
            if im is None:
                continue
            R = _quat_wxyz_to_matrix(*im["qvec"])
            poses[i, :3] = -R.T @ np.asarray(im["tvec"], np.float64)
            poses[i, 3:7] = _matrix_to_quat_xyzw(R.T)
        self.Twc_gt = poses if np.isfinite(poses).any() else None

        cam = cameras[min(cameras.keys())]
        p = cam["params"]
        model = self._MODELS.get(cam["model_id"], "PINHOLE")
        if model == "SIMPLE_PINHOLE":
            calib = [p[0], p[0], p[1], p[2]]
        elif model == "PINHOLE":
            calib = [p[0], p[1], p[2], p[3]]
        elif model == "SIMPLE_RADIAL":
            calib = [p[0], p[0], p[1], p[2], p[3], 0.0, 0.0, 0.0]
        elif model == "RADIAL":
            calib = [p[0], p[0], p[1], p[2], p[3], p[4], 0.0, 0.0]
        else:  # OPENCV: fx fy cx cy k1 k2 p1 p2
            calib = list(p[:8])
        self._colmap_calib = {"width": int(cam["width"]), "height": int(cam["height"]),
                              "calibration": calib}
        # an explicit --calib YAML still wins inside _finish_init
        self._forced_intrinsics = self._colmap_calib
        self._finish_init(args)

    def _probe_size(self):
        return self._colmap_calib["height"], self._colmap_calib["width"]


def _quat_wxyz_to_matrix(qw, qx, qy, qz):
    q = np.asarray([qw, qx, qy, qz], np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _matrix_to_quat_xyzw(R):
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # rare 180-degree case
        x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0
        s = 4 * x if x > 1e-8 else 1.0
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
        w = (R[2, 1] - R[1, 2]) / s
    q = np.asarray([x, y, z, w], np.float64)
    return q / np.linalg.norm(q)


class _Overrides:
    """``args`` with some attributes replaced, without writing to it."""

    def __init__(self, args, **overrides):
        self._args, self._overrides = args, overrides

    def __getattr__(self, name):
        if name in self._overrides:
            return self._overrides[name]
        return getattr(self._args, name)


class SyntheticDataset(BaseDataset):
    """Procedural textured-plane flythrough (no files needed).

    ``args`` supplies ``test_hold`` (every test_hold-th frame but the
    first is a held-out test frame; <= 0 for none), ``max_size_slam``
    (the SLAM stream's long edge) and ``downsampling`` (the map stream's
    factor, default 1).  The focal length is 0.8 * width, whatever
    ``args.calib`` and ``args.init_focal`` say (the JAX package writes
    those into ``args``; here ``args`` is left as it is).
    """

    def __init__(self, args, n_frames: int = 30, width: int = 320, height: int = 240):
        self._w, self._h = width, height
        self.image_dir = ""
        self.image_name_list = [f"synth_{i:04d}.png" for i in range(n_frames)]
        self.timestamp = list(np.arange(n_frames, dtype=np.float64))
        # ground truth: slow x-translation, identity rotation (t, q_xyzw)
        poses = np.zeros((n_frames, 7))
        poses[:, 0] = 0.02 * np.arange(n_frames)
        poses[:, 6] = 1.0
        self.Twc_gt = poses
        self._finish_init(_Overrides(args, calib=None, init_focal=0.8 * width))
        self._img_cache: Dict[int, np.ndarray] = {}

    def _probe_size(self):
        return self._h, self._w

    def __getitem__(self, index) -> Tuple[np.ndarray, Dict[str, Any]]:
        img = self._img_cache.get(index)
        if img is None:
            u, v = np.meshgrid(np.arange(self._w), np.arange(self._h))
            tx = 0.02 * index
            # plane at z=2: pixel shift = f*tx/2
            phase = tx * 0.8 * self._w / 2.0
            img = np.stack([
                0.5 + 0.4 * np.sin((u + phase) / 9.0),
                0.5 + 0.4 * np.cos(v / 7.0),
                0.5 + 0.3 * np.sin((u + phase + v) / 11.0),
            ], axis=-1)
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            self._img_cache[index] = img
        info = dict(self.infos[self.image_name_list[index]])
        info["Twc_gt"] = self.Twc_gt[index]
        return img, info


def load_dataset(args):
    """Dataset factory (the reference's ``dataloaders/utils_load.py``):
    ``synthetic``, ``tum``, ``colmap``, else an image folder, which is read
    as a COLMAP scene when ``<source>/sparse/0/cameras.bin`` exists."""
    name = getattr(args, "dataset_name", "selfCaptured")
    if name == "synthetic":
        return SyntheticDataset(args)
    if name == "tum":
        return TUMDataset(args)
    if name == "colmap":
        return ColmapDataset(args)
    sp = getattr(args, "source_path", "") or ""
    if name == "selfCaptured" and os.path.isfile(os.path.join(sp, "sparse", "0", "cameras.bin")):
        return ColmapDataset(args)
    return SelfCapturedDataset(args)
