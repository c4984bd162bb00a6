"""Frontend: tracks each incoming frame.

Port of ``artdeco_tpu/vslam/frontend.py`` (``CameraTracker`` and
``Frontend``): ``process_frame`` tracks one frame against the last
keyframe and returns the backend's message dict, or None.  Each tracked
frame runs the runner's match (the matching cascade, K3 included) and
``tracker.track_step``, then pulls five flags to the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.vslam import tracker as trk
from artdeco_tpu_torch.vslam.frame import Frame, KeyframeStyle
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from artdeco_tpu_torch.vslam.tracker import TrackingConfig


class CameraTracker:
    """Two-view tracking against the last keyframe.

    ``timers`` sums wall time per stage ("trk.match", "trk.step"); with
    ``sync_timing`` the device is synchronised at each stage boundary, so
    the split is of device time rather than of launch time."""

    def __init__(self, config: dict, runner, keyframes: KeyframeStore, H_slam: int,
                 W_slam: int, K_slam, min_displacement: float, thres_keyframe: float,
                 optimize_focal: bool = False, covariance_filter: bool = False,
                 point_fusion: bool = True, *, device):
        self.config = config
        self.cfg = TrackingConfig.from_dict(config["tracking"])
        self.runner = runner
        self.keyframes = keyframes
        self.device = torch.device(device)
        self.H_slam, self.W_slam = H_slam, W_slam
        self.K_slam = torch.as_tensor(np.asarray(K_slam, np.float32), device=self.device)
        self.min_displacement = min_displacement
        self.thres_keyframe = thres_keyframe
        self.optimize_focal = optimize_focal
        self.covariance_filter = covariance_filter
        self.point_fusion = point_fusion
        self.timers: dict = {}
        self.sync_timing = False
        self.idx_f2k = None
        self.last_embedding = None
        self._emb_kf_idx = -1   # keyframe index last_embedding belongs to
        self.last_dist = 0.0
        self._last_pair = None

    def _tick(self, key: str, t0: float) -> float:
        if self.sync_timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        acc = self.timers.setdefault(key, [0.0, 0])
        acc[0] += now - t0
        acc[1] += 1
        return now

    def track_init(self, frame: Frame):
        X, C, feat, pos = self.runner.inference_mono(frame.img)
        frame = frame.update_pointmap(X[0], C[0]).update_pointmap(X[1], C[1])
        self.last_embedding = (feat, pos)
        self._emb_kf_idx = 0
        self._last_pair = dict(kind="mono", X=X, C=C, feat=feat, pos=pos)
        return frame, False, True, True

    def take_last_pair(self):
        """Hand the latest frame's decode payload to the backend (one-shot)."""
        out, self._last_pair = self._last_pair, None
        return out

    def track(self, frame: Frame):
        """Returns (frame, lost, is_keyframe, is_keyframe_map)."""
        if len(self.keyframes) == 0:
            return self.track_init(frame)
        kf_idx = self.keyframes.last_index()
        keyframe = self.keyframes[kf_idx]
        if kf_idx != self._emb_kf_idx:
            # a keyframe the tracker did not create (relocalisation): its
            # embedding and pose come from the store
            stored = self.keyframes.get_embedding(kf_idx)
            if stored is not None:
                self.last_embedding = stored
            self.idx_f2k = None
            self._emb_kf_idx = kf_idx
            frame = dataclasses.replace(frame, T_WC=keyframe.T_WC)

        t0 = time.perf_counter()
        (idx_f2k, valid_match_k, Xff, Cff, Qff, Xkf, Ckf, Qkf, featf, posf
         ) = self.runner.match_asymmetric(frame.img, keyframe.img, idx_i2j_init=self.idx_f2k,
                                          embeddings_j=self.last_embedding)
        t0 = self._tick("trk.match", t0)
        self.idx_f2k = idx_f2k
        self._last_pair = dict(kind="pair", last_idx=kf_idx, idx=idx_f2k, valid=valid_match_k,
                               Xkk=Xff, Ckk=Cff, Qkk=Qff, Xlk=Xkf, Clk=Ckf, Qlk=Qkf,
                               feat=featf, pos=posf)
        (fX, fC, fN, T_WCf, T_CkCf, K_new, kX, kC, kN, flags) = trk.track_step(
            Xff, Cff, frame.X_canon, frame.C, frame.N, Xkf, Ckf, keyframe.X_canon,
            keyframe.C, keyframe.N, idx_f2k, valid_match_k, Qff, Qkf, frame.T_WC,
            keyframe.T_WC, self.K_slam, float(self.last_dist), float(self.min_displacement),
            (self.H_slam, self.W_slam), self.cfg, thres_keyframe=float(self.thres_keyframe),
            optimize_focal=self.optimize_focal, covariance_filter=self.covariance_filter)
        match_frac, ok, is_kf_f, is_km_f, dist = flags.tolist()    # the one pull
        self._tick("trk.step", t0)
        frame = dataclasses.replace(frame, X_canon=fX, C=fC, N=fN)
        if match_frac < self.cfg.min_match_frac or ok < 0.5:
            return frame, True, False, False
        if self.optimize_focal:
            self.K_slam = K_new
        frame = dataclasses.replace(frame, T_WC=T_WCf)
        if self.point_fusion:
            self.keyframes.update_payload(kf_idx, kX, kC, kN)
        is_keyframe = is_kf_f > 0.5
        if is_keyframe:
            self.idx_f2k = None
            self.last_embedding = (featf, posf)
            self._emb_kf_idx = kf_idx + 1  # this frame appends next
            is_keyframe_map = True
            self.last_dist = 0.0
        else:
            is_keyframe_map = is_km_f > 0.5
            if is_keyframe_map:
                self.last_dist = float(dist)
        return frame, False, is_keyframe, is_keyframe_map


class Frontend:
    """Tracks each frame and produces the backend's messages."""

    def __init__(self, args, config: dict, dataset, keyframes: KeyframeStore, runner, *,
                 device=None):
        self.args = args
        self.config = config
        self.dataset = dataset
        self.keyframes = keyframes
        self.runner = runner
        self.device = resolve(device)
        min_disp = max(getattr(args, "min_displacement", 0.03) * dataset.W_slam, 30)
        self.tracker = CameraTracker(
            config, runner, keyframes, dataset.H_slam, dataset.W_slam, dataset.K_slam,
            min_displacement=min_disp, thres_keyframe=getattr(args, "thres_keyframe", 0.8),
            optimize_focal=getattr(args, "optimize_focal", False),
            covariance_filter=getattr(args, "covariance_filter", False),
            point_fusion=getattr(args, "point_fusion_frontend", True), device=self.device)
        self.frames_info: list = []
        self.frames_Twc_gt: list = []
        self.lost_number = 0
        self.last_T_WC = lie.sim3_identity(device=self.device)
        self.frame_id = 0

    def upload(self, original_image):
        """(H, W, 3) raw frame -> the SLAM image on the device.  A runner
        with ``bind`` (the oracle) learns the tensor's frame here, from the
        host copy."""
        img_host = self.dataset.transform.to_slam(original_image)
        img = torch.from_numpy(np.ascontiguousarray(img_host)).to(self.device)
        bind = getattr(self.runner, "bind", None)
        if bind is not None:
            bind(img, img_host)
        return img

    def process_frame(self, original_image, info: dict) -> Optional[dict]:
        """Track one frame; returns the backend message or None.

        ``original_image`` is an (H, W, 3) raw frame, or ("slam_dev", img)
        when an upload-ahead thread already put the SLAM image on the
        device (and bound it to its frame: ``runtime/system._UploadAhead``)."""
        if isinstance(original_image, tuple) and original_image[0] == "slam_dev":
            img_slam = original_image[1]
        else:
            img_slam = self.upload(original_image)
        is_test = info.get("is_test", False)
        timestamp = float(info.get("timestamp", self.frame_id))
        gt = info.get("Twc_gt")
        if gt is not None and np.all(np.isfinite(gt)):
            self.frames_Twc_gt.append([timestamp, *np.asarray(gt, np.float64).tolist()])

        T_init = self.last_T_WC if self.frame_id > 0 else lie.sim3_identity(device=self.device)
        frame = Frame.create(img_slam, frame_id=self.frame_id, frame_time=timestamp,
                             T_WC=T_init)
        frame, lost, is_kf, is_kf_map = self.tracker.track(frame)
        if getattr(self.args, "use_same_set_of_keyframes", False):
            is_kf = is_kf or is_kf_map

        style = None
        if lost:
            self.lost_number += 1
            style = KeyframeStyle.LOST
        elif is_kf:
            self.keyframes.append(frame)
            style = KeyframeStyle.KEYFRAME
        elif is_kf_map or is_test or getattr(self.args, "use_all_frames", False):
            self._store_rel(frame, self.keyframes.last_index(), self.keyframes.last_keyframe())
            style = KeyframeStyle.MAPPER_FRAME
        else:
            kf = self.keyframes.last_keyframe()
            if kf is not None:
                self._store_rel(frame, self.keyframes.last_index(), kf)
        if not lost:
            self.last_T_WC = frame.T_WC
        self.frame_id += 1
        if style is None:
            return None
        return {
            "keyframe_style": int(style),
            "is_important": bool(is_kf_map or is_test),
            "is_test": bool(is_test),
            "keyframe_id": self.keyframes.last_index(),
            "frame_id": frame.frame_id,
            "T_WC": frame.T_WC.detach().cpu().numpy(),
            "timestamp": timestamp,
            "focal": float(self.tracker.K_slam[0, 0]),
            "frame": frame,
            "track_match": (self.tracker.take_last_pair()
                            if style == KeyframeStyle.KEYFRAME else None),
        }

    def _store_rel(self, frame: Frame, kf_index: int, kf: Frame):
        # the keyframe-relative pose stays on the device; the host copy is
        # made once, in estimated_trajectory
        T_rel = lie.sim3_mul(lie.sim3_inv(kf.T_WC), frame.T_WC)
        self.frames_info.append([frame.frame_id, frame.frame_time, kf_index, T_rel])

    # -- trajectories --------------------------------------------------------
    def estimated_trajectory(self) -> np.ndarray:
        """All tracked non-keyframe frames as [t, tx..qw] through their
        keyframe-relative poses."""
        rows = []
        for fid, ts, kf_idx, T_rel in self.frames_info:
            T_kf = torch.as_tensor(self.keyframes.T_WC[kf_idx])
            T = lie.sim3_mul(T_kf, T_rel.detach().cpu())
            rows.append([ts, *T[:7].tolist()])
        return np.asarray(rows) if rows else np.zeros((0, 8))

    def keyframe_trajectory(self) -> np.ndarray:
        rows = [[float(self.keyframes.timestamp[i]), *self.keyframes.T_WC[i][:7].tolist()]
                for i in range(len(self.keyframes))]
        return np.asarray(rows) if rows else np.zeros((0, 8))
