"""Keypoint-SfM pose bootstrap and incremental PnP registration.

Port of ``artdeco_tpu/poses/pose_initializer.py`` (the legacy
on-the-fly-NVS initialisation; the main pipeline uses the MASt3R tracker):
match the first and last of a few frames, gate by fundamental-matrix
RANSAC, triangulate against a fixed baseline guess, refine with mini
bundle adjustment; then register new frames by PnP against the
triangulated points.

One departure (ROADMAP.md section 3): the JAX package keys the
triangulated points by their position in the bootstrap's match list and
looks them up by keypoint index of the last keyframe, which hands PnP the
wrong 3D point for a 2D match unless both frames list their keypoints in
the same order.  Here each point is keyed by the keypoint index it was
triangulated from, in each keyframe.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.mapper.keyframe import sixd_to_mtx
from artdeco_tpu_torch.poses.feature_detector import DescribedKeypoints, FeatureDetector
from artdeco_tpu_torch.poses.matcher import match_described
from artdeco_tpu_torch.poses.mini_ba import mini_ba
from artdeco_tpu_torch.poses.pnp import opt_pnp
from artdeco_tpu_torch.poses.ransac import RANSACEstimator
from artdeco_tpu_torch.poses.triangulator import triangulate


class PoseInitializer:
    """Pose bootstrap on ``device`` (None: the CUDA device).  ``stats``
    holds the last bootstrap's counts (matches, inliers, triangulated)."""

    def __init__(self, f: float, centre, num_kpts: int = 1024, ransac_samples: int = 512,
                 match_max_error: float = 2e-3, min_num_inliers: int = 50,
                 ba_iters: int = 40, *, device=None):
        self.device = resolve(device)
        self.f = float(f)
        self.centre = torch.tensor([float(centre[0]), float(centre[1])], device=self.device)
        self.K = torch.tensor([[self.f, 0, float(centre[0])], [0, self.f, float(centre[1])],
                               [0, 0, 1.0]], device=self.device)
        self.detector = FeatureDetector(num_kpts=num_kpts, device=self.device)
        self.ransac = RANSACEstimator(ransac_samples, match_max_error)
        self.min_num_inliers = min_num_inliers
        self.ba_iters = ba_iters
        self.keyframes: List[DescribedKeypoints] = []
        self.Rts: List[np.ndarray] = []            # world -> cam 4x4
        self.points3d: Optional[np.ndarray] = None
        self.stats: dict = {}

    def detect(self, img_chw) -> DescribedKeypoints:
        return self.detector(img_chw)

    def bootstrap(self, imgs) -> bool:
        """Match the first and the last frame, gate by RANSAC, triangulate
        with the second camera at a fixed guess, refine by mini-BA."""
        dks = [self.detect(im) for im in imgs]
        d0, d1 = dks[0], dks[-1]
        m = match_described(d0, d1, min_sim=0.7)
        self.stats = {"matches": int(m.idx.numel())}
        if m.idx.numel() < self.min_num_inliers:
            return False
        p0 = d0.kpts[m.idx]
        p1 = m.kpts_other
        _, inl, count = self.ransac.estimate(p0, p1)
        self.stats["inliers"] = int(count)
        if int(count) < self.min_num_inliers:
            return False
        p0i, p1i = p0[inl], p1[inl]

        # the second camera at a small sideways guess; BA fixes the rest
        Rt0 = torch.eye(4, device=self.device)
        Rt1 = torch.eye(4, device=self.device)
        Rt1[0, 3] = 0.1
        world, _, _, valid = triangulate(p0i, p1i[None], Rt0, Rt1[None],
                                         torch.tensor(self.f, device=self.device), self.centre,
                                         max_error=5e-2, min_dis=1e-6)
        n_valid = int(valid.sum())
        self.stats["triangulated"] = n_valid
        if n_valid < self.min_num_inliers:
            return False
        uv_obs = torch.stack([p0i[valid], p1i[valid]])
        R6D0 = torch.stack([Rt0[:3, :2], Rt1[:3, :2]])
        t0 = torch.stack([Rt0[:3, 3], Rt1[:3, 3]])
        ok = torch.ones((2, n_valid), dtype=torch.bool, device=self.device)
        R6D, t, _, xyz, _ = mini_ba(R6D0, t0, world[valid], uv_obs, ok,
                                    torch.tensor(self.f, device=self.device), self.centre,
                                    iters=self.ba_iters, optimize_pts=True)
        for c in range(2):
            Rt = np.eye(4, dtype=np.float32)
            Rt[:3, :3] = sixd_to_mtx(R6D[c]).cpu().numpy()
            Rt[:3, 3] = t[c].cpu().numpy()
            self.Rts.append(Rt)
        self.points3d = xyz.cpu().numpy()
        self.keyframes = [d0, d1]
        # each point's keypoint index in each keyframe
        self._kpt_idx = [m.idx[inl][valid].cpu().numpy(), m.idx_other[inl][valid].cpu().numpy()]
        return True

    def register_incremental(self, img_chw) -> Optional[np.ndarray]:
        """PnP of a new frame against the bootstrap's points, from the last
        pose.  Returns its world -> cam 4x4, or None."""
        if self.points3d is None:
            return None
        d = self.detect(img_chw)
        m = match_described(self.keyframes[-1], d, min_sim=0.7)
        # keep the matches whose keyframe keypoint was triangulated
        ref_rows = {int(k): i for i, k in enumerate(self._kpt_idx[-1])}
        idx = m.idx.cpu().numpy()
        sel = [j for j, k in enumerate(idx) if int(k) in ref_rows]
        if len(sel) < 6:
            return None
        rows = [ref_rows[int(idx[j])] for j in sel]
        X = torch.as_tensor(self.points3d[rows], device=self.device)
        uv = m.kpts_other[torch.as_tensor(sel, device=self.device)]
        T_last = torch.as_tensor(self.Rts[-1], device=self.device)
        T0 = torch.cat([T_last[:3, 3], lie.matrix_to_quat(T_last[:3, :3])])
        T_out, _ = opt_pnp(T0[None], X[None], uv[None],
                           torch.ones((1, len(rows)), dtype=torch.bool, device=self.device),
                           self.K)
        Rt = lie.se3_matrix(T_out[0]).cpu().numpy().astype(np.float32)
        self.Rts.append(Rt)
        return Rt
