"""Datasets of the port.

Port of ``SyntheticDataset`` from ``artdeco_tpu/dataio/dataset.py``: the
procedural textured-plane flythrough, with the same frames, ground-truth
poses, intrinsics and test split.  Host-only (numpy).  ``load_dataset``
is the factory; the real-image datasets (TUM, COLMAP, self-captured) are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from artdeco_tpu_torch.dataio.camera import PinholeCamera


class SyntheticDataset:
    """Procedural textured-plane flythrough (no files needed).

    ``args`` supplies ``test_hold`` (every test_hold-th frame but the
    first is a held-out test frame; <= 0 for none), ``max_size_slam``
    (the SLAM stream's long edge) and ``downsampling`` (the map stream's
    integer factor, default 1).  The focal length is 0.8 * width.
    """

    def __init__(self, args, n_frames: int = 30, width: int = 320, height: int = 240):
        self._w, self._h = width, height
        self.image_name_list = [f"synth_{i:04d}.png" for i in range(n_frames)]
        self.timestamp = list(np.arange(n_frames, dtype=np.float64))
        # ground truth: slow x-translation, identity rotation (t, q_xyzw)
        poses = np.zeros((n_frames, 7))
        poses[:, 0] = 0.02 * np.arange(n_frames)
        poses[:, 6] = 1.0
        self.Twc_gt = poses

        test_hold = getattr(args, "test_hold", -1)
        self.infos = {
            name: {
                "is_test": (test_hold > 0) and (i % test_hold == 0) and i != 0,
                "name": name,
                "timestamp": self.timestamp[i],
            }
            for i, name in enumerate(self.image_name_list)
        }

        focal = 0.8 * width
        self.transform = PinholeCamera(getattr(args, "max_size_slam", 512), width, height,
                                       [focal, focal, width / 2, height / 2],
                                       getattr(args, "downsampling", 1.0))
        self.H, self.W = height, width
        self.H_slam, self.W_slam = self.transform.H_slam, self.transform.W_slam
        self.H_map, self.W_map = self.transform.H_map, self.transform.W_map
        self.K_slam = self.transform.K_slam
        self.K_map = self.transform.K_map
        self._img_cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.image_name_list)

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
    """The dataset ``args.dataset_name`` names (the JAX package's factory);
    only ``synthetic`` is ported."""
    name = getattr(args, "dataset_name", "selfCaptured")
    if name == "synthetic":
        return SyntheticDataset(args)
    raise NotImplementedError(
        f"dataset {name!r}: only the synthetic dataset is ported; the real-image "
        "datasets and the native loader wait (ROADMAP.md, queue 1)")
