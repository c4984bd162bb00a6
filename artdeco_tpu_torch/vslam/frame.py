"""Frame state: the per-frame tracked entity (pointmap, confidence, pose).

Port of ``artdeco_tpu/vslam/frame.py``: a frozen dataclass whose
confidence-weighted pointmap fusion returns a new Frame.  Its tensors
live on the image's device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from artdeco_tpu_torch.geometry import lie


def fuse_pointmap(X0, C0, N0, X, C):
    """Confidence-weighted fusion of (X, C) into the state (X0, C0, N0):
    the first observation is taken as it is."""
    first = N0 == 0
    denom = torch.where(first, torch.ones_like(C0), C0 + C)
    X_new = torch.where(first, X, (C0 * X0 + C * X) / torch.clamp_min(denom, 1e-12))
    C_new = torch.where(first, C, C0 + C)
    return X_new, C_new, N0 + 1


def average_conf(C, N):
    return C / torch.clamp_min(N, 1).to(C.dtype)


class Mode(enum.IntEnum):
    TRACKING = 0
    RELOC = 1
    OPTIMIZING = 2
    TERMINATED = 3


class KeyframeStyle(enum.IntEnum):
    """Frontend frame classification."""
    LOST = 0
    KEYFRAME = 1       # SLAM keyframe -> backend global optimization
    MAPPER_FRAME = 2   # map-only frame -> dense points for the mapper
    COMMON = 3         # tracked, not propagated


@dataclasses.dataclass(frozen=True)
class Frame:
    """One RGB frame with its canonical pointmap estimate.

    img:     (3, H, W) in [-1, 1]
    T_WC:    (8,) Sim3 world-from-camera
    X_canon: (H*W, 3) canonical pointmap (camera frame)
    C:       (H*W, 1) accumulated confidence
    N:       () int32 number of fused predictions
    """

    img: torch.Tensor
    T_WC: torch.Tensor
    X_canon: torch.Tensor
    C: torch.Tensor
    N: torch.Tensor
    frame_id: int = 0
    frame_time: float = 0.0

    @staticmethod
    def create(img, frame_id: int = 0, frame_time: float = 0.0,
               T_WC: Optional[torch.Tensor] = None) -> "Frame":
        c, h, w = img.shape
        n, dev = h * w, img.device
        if T_WC is None:
            T_WC = lie.sim3_identity(device=dev)
        return Frame(img=img, T_WC=T_WC,
                     X_canon=torch.zeros(n, 3, dtype=img.dtype, device=dev),
                     C=torch.zeros(n, 1, dtype=img.dtype, device=dev),
                     N=torch.zeros((), dtype=torch.int32, device=dev),
                     frame_id=frame_id, frame_time=frame_time)

    def update_pointmap(self, X, C) -> "Frame":
        X_new, C_new, N_new = fuse_pointmap(self.X_canon, self.C, self.N, X, C)
        return dataclasses.replace(self, X_canon=X_new, C=C_new, N=N_new)

    def get_average_conf(self):
        return average_conf(self.C, self.N)

    @property
    def hw(self):
        return self.img.shape[-2], self.img.shape[-1]
