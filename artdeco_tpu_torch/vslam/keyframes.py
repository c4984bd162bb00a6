"""Keyframe store: fixed-capacity SoA of tracked keyframes.

Port of ``artdeco_tpu/vslam/keyframes.py``.  Scalar metadata (poses,
timestamps, versions) is a host numpy SoA; the O(H*W) payloads (image,
pointmap, confidence, count) stay device tensors stored by reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.vslam.frame import Frame


class KeyframeStore:
    """Fixed-capacity keyframe SoA on ``device``."""

    def __init__(self, h: int, w: int, K_slam=None, buffer: int = 2048,
                 dtype=np.float32, *, device=None):
        self.h, self.w = h, w
        self.buffer = buffer
        self.device = resolve(device)
        self.n_size = 0
        self.dataset_idx = np.zeros(buffer, np.int32)
        self.cam_id = np.zeros(buffer, np.int32)
        self.timestamp = np.zeros(buffer, np.float64)
        self.T_WC = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], dtype), (buffer, 1))
        self.is_dirty = np.zeros(buffer, bool)
        self.version = np.zeros(buffer, np.int64)
        self.K = None if K_slam is None else np.asarray(K_slam, dtype)
        self._img: dict = {}
        self._X: dict = {}
        self._C: dict = {}
        self._N: dict = {}
        self._embeddings: dict = {}

    def __len__(self) -> int:
        return self.n_size

    def __getitem__(self, idx: int) -> Frame:
        return Frame(img=self._img[idx],
                     T_WC=torch.as_tensor(self.T_WC[idx], device=self.device),
                     X_canon=self._X[idx], C=self._C[idx], N=self._N[idx],
                     frame_id=int(self.dataset_idx[idx]),
                     frame_time=float(self.timestamp[idx]))

    def __setitem__(self, idx: int, f: Frame) -> None:
        self.n_size = max(idx + 1, self.n_size)
        self.dataset_idx[idx] = f.frame_id
        self.timestamp[idx] = f.frame_time
        self.T_WC[idx] = np.asarray(f.T_WC.detach().cpu()).reshape(8)   # syncs
        self._img[idx] = f.img
        self._X[idx] = f.X_canon
        self._C[idx] = f.C
        self._N[idx] = f.N
        self.is_dirty[idx] = True
        self.version[idx] += 1

    def X_dev(self, idx: int):
        return self._X[idx]

    def C_dev(self, idx: int):
        return self._C[idx]

    def N_dev(self, idx: int):
        return self._N[idx]

    def img_dev(self, idx: int):
        return self._img[idx]

    def update_payload(self, idx: int, X, C, N) -> None:
        """Replace a slot's device payloads (no pose pull)."""
        self._X[idx] = X
        self._C[idx] = C
        self._N[idx] = N
        self.is_dirty[idx] = True
        self.version[idx] += 1

    def append(self, f: Frame) -> int:
        idx = self.n_size
        self[idx] = f
        return idx

    def pop_last(self) -> None:
        idx = self.n_size - 1
        self.n_size -= 1
        for d in (self._img, self._X, self._C, self._N, self._embeddings):
            d.pop(idx, None)

    def last_keyframe(self) -> Optional[Frame]:
        return None if self.n_size == 0 else self[self.n_size - 1]

    def last_index(self) -> int:
        return self.n_size - 1

    def update_T_WCs(self, T_WCs, idx) -> None:
        self.T_WC[np.asarray(idx)] = np.asarray(T_WCs).reshape(-1, 8)

    def get_dirty_idx(self) -> np.ndarray:
        idx = np.where(self.is_dirty)[0]
        self.is_dirty[:] = False
        return idx

    def put_embedding(self, index: int, feat, pos) -> None:
        self._embeddings[index] = (feat, pos)

    def get_embedding(self, index: int):
        return self._embeddings.get(index)

    def set_intrinsics(self, K) -> None:
        self.K = np.asarray(K, np.float32)

    def get_intrinsics(self):
        return self.K
