"""Oracle pointmap runner: ground-truth geometry in the model runner's shape.

Port of ``artdeco_tpu/models/oracle.py``.  It stands in for a perfectly
trained MASt3R: pointmaps come from an analytic scene (the plane
z_w = z_plane) and known poses, descriptors encode the true world
position.  The geometry is numpy on the host, uploaded once per frame;
every match then runs on device tensors, as the real model's outputs
would.

Frame lookup: ``register`` keys a frame by the sha1 of its host SLAM
image.  The frontend (or the system's upload thread) uploads each image
once and ``bind``s the device tensor to its host copy, so a frame finds
its id through the identity of the tensor (weakref-checked, kept while
the tensor lives) and never pulls an image back from the card;
``d2h_lookups`` counts the lookups that had to.  The
embedding "token" (feat, pos) that carries a frame id stays on the host.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Dict, Tuple

import numpy as np
import torch

from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.ops import matching

_FREQS = np.asarray([2.3, 7.1, 19.7, 41.3], np.float32)


def _host_key(img) -> bytes:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return hashlib.sha1(np.asarray(img).tobytes()).digest()


class OracleRunner:
    """Drop-in for the MASt3R runner over a plane scene with known poses."""

    def __init__(self, hw: Tuple[int, int], K: np.ndarray, match_cfg: dict,
                 z_plane: float = 2.0, conf: float = 5.0, *, device=None):
        self.h, self.w = hw
        self.K = np.asarray(K, np.float32)
        self.match_cfg = dict(match_cfg)
        self.z_plane = z_plane
        self.conf_value = conf
        self.device = resolve(device)
        self._by_hash: Dict[bytes, int] = {}
        self._poses: Dict[int, np.ndarray] = {}
        self._pm_cache: Dict[int, np.ndarray] = {}
        self._desc_cache: Dict[int, np.ndarray] = {}
        self._dev_cache: dict = {}
        self._conf_dev = None
        self._by_id: Dict[int, tuple] = {}
        self._lock = threading.RLock()     # bind runs on the upload thread
        self._q_cache: dict = {}
        self.d2h_lookups = 0

    # -- registration -------------------------------------------------------
    def register(self, img, frame_id: int, T_wc_sim3: np.ndarray):
        """Key frame ``frame_id`` (pose ``T_wc_sim3``) by its host image;
        its pointmap and descriptors go to the device now, as the model
        would produce them there (no tracked frame pays an upload)."""
        self._by_hash[_host_key(img)] = frame_id
        self._poses[frame_id] = np.asarray(T_wc_sim3, np.float32)
        self._dev(frame_id)

    def bind(self, img_dev, img_host) -> None:
        """Tie an uploaded image tensor to its host copy's frame id."""
        self._remember(img_dev, self._by_hash[_host_key(img_host)])

    def _remember(self, img, fid: int) -> None:
        # an entry lives as long as its tensor: a work item may use a frame's
        # image long after it was uploaded (the mapper worker lags tracking)
        key = id(img)

        def forget(ref, key=key):
            with self._lock:
                hit = self._by_id.get(key)
                if hit is not None and hit[0] is ref:
                    del self._by_id[key]

        with self._lock:
            self._by_id[key] = (weakref.ref(img, forget), fid)

    def _fid(self, img) -> int:
        hit = self._by_id.get(id(img))
        if hit is not None and hit[0]() is img:
            return hit[1]
        if isinstance(img, torch.Tensor) and img.device.type != "cpu":
            self.d2h_lookups += 1
        fid = self._by_hash[_host_key(img)]
        if isinstance(img, torch.Tensor):
            self._remember(img, fid)
        return fid

    # -- geometry (numpy, cached) -------------------------------------------
    @staticmethod
    def _np_quat_R(q: np.ndarray) -> np.ndarray:
        x, y, z, w = q
        return np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float32)

    def _np_sim3_act(self, T: np.ndarray, X: np.ndarray) -> np.ndarray:
        R = self._np_quat_R(T[3:7])
        return (T[7] * (X @ R.T) + T[0:3]).astype(np.float32)

    def _pointmap(self, fid: int) -> np.ndarray:
        """Plane z_w = z_plane in frame fid's camera coords, pixel-aligned."""
        hit = self._pm_cache.get(fid)
        if hit is not None:
            return hit
        T = self._poses[fid]
        R = self._np_quat_R(T[3:7])
        s, t = T[7], T[0:3]
        u, v = np.meshgrid(np.arange(self.w), np.arange(self.h))
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
        d_w = s * (rays @ R.T)
        sc = (self.z_plane - t[2]) / d_w[..., 2]
        out = (rays * sc[..., None]).reshape(-1, 3).astype(np.float32)
        self._pm_cache[fid] = out
        return out

    def _desc(self, fid: int) -> np.ndarray:
        """World-position descriptors (24 channels): a non-harmonic
        frequency bank of the world point, so matched pixels share
        descriptors and the position is unique within the search window."""
        hit = self._desc_cache.get(fid)
        if hit is not None:
            return hit
        Xw = self._np_sim3_act(self._poses[fid], self._pointmap(fid))
        ang = Xw[:, :, None] * _FREQS
        f = np.concatenate([np.sin(ang).reshape(len(Xw), -1),
                            np.cos(ang).reshape(len(Xw), -1)], axis=-1).astype(np.float32)
        out = f / np.linalg.norm(f, axis=-1, keepdims=True)
        self._desc_cache[fid] = out
        return out

    # -- device caches -------------------------------------------------------
    def _dev(self, fid: int):
        """(X_cam (HW, 3), desc (HW, F), T_WC (8,)) on the device."""
        hit = self._dev_cache.get(fid)
        if hit is None:
            P = self._poses[fid]
            T = P[:8] if P.shape[0] == 8 else np.concatenate([P, [1.0]])
            hit = tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)
                        for a in (self._pointmap(fid), self._desc(fid), T))
            self._dev_cache[fid] = hit
        return hit

    def _conf_device(self):
        if self._conf_dev is None:
            self._conf_dev = torch.full((self.h * self.w, 1), self.conf_value,
                                        dtype=torch.float32, device=self.device)
        return self._conf_dev

    def _cross_dev(self, fid_src: int, fid_dst: int):
        """Frame src's points in dst's camera, on the device (cached)."""
        key = ("cross", fid_src, fid_dst)
        hit = self._dev_cache.get(key)
        if hit is None:
            Xs, _, Ts = self._dev(fid_src)
            Td = self._dev(fid_dst)[2]
            hit = lie.sim3_act(lie.sim3_mul(lie.sim3_inv(Td), Ts), Xs)
            self._dev_cache[key] = hit
            if len(self._dev_cache) > 4096:
                self._dev_cache.pop(next(iter(self._dev_cache)))
        return hit

    # -- runner surface ---------------------------------------------------------
    @staticmethod
    def _token(fid: int):
        feat = torch.zeros(1, 4, 4)
        feat[0, 0, 0] = fid
        return feat, torch.zeros(1, 4, 2, dtype=torch.int32)

    def encode_image(self, img):
        """The encoder's (feat, pos) stand-in: a host token of the frame id."""
        return self._token(self._fid(img[0] if img.dim() == 4 else img))

    @staticmethod
    def _fid_from_feat(feat) -> int:
        return int(feat[0, 0, 0])

    def inference_mono(self, img):
        fid = self._fid(img)
        X = self._dev(fid)[0]
        C = self._conf_device()
        feat, pos = self._token(fid)
        return torch.stack([X, X]), torch.stack([C, C]), feat, pos

    def match_asymmetric(self, img_i, img_j, idx_i2j_init=None, embeddings_i=None,
                         embeddings_j=None):
        """Frame j's pixels matched into frame i.  Returns (idx, valid, Xii,
        Cii, Qii, Xji, Cji, Qji, feat_i, pos_i)."""
        fi = self._fid(img_i) if embeddings_i is None else self._fid_from_feat(embeddings_i[0])
        fj = self._fid(img_j) if embeddings_j is None else self._fid_from_feat(embeddings_j[0])
        Xii, Dii, _ = self._dev(fi)
        Xji = self._cross_dev(fj, fi)
        Dji = self._dev(fj)[1]
        h, w = self.h, self.w
        idx, valid = matching.match(self.match_cfg, Xii.reshape(1, h, w, 3),
                                    Xji.reshape(1, h, w, 3), Dii.reshape(1, h, w, -1),
                                    Dji.reshape(1, h, w, -1), idx_1_to_2_init=idx_i2j_init)
        C = self._conf_device()
        feat, pos = self._token(fi)
        return idx, valid, Xii, C, C, Xji, C, C, feat, pos

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j, hw):
        """Both directions of every edge (i, j) in one batched match: rows
        [0, b) match frame j's pixels into frame i, rows [b, 2b) frame i's
        into frame j, so K3 runs once per row.  Returns (idx_i2j, idx_j2i,
        valid_j, valid_i, Qii, Qjj, Qji, Qij)."""
        h, w = hw
        b = feat_i.shape[0]
        fis = [int(feat_i[e, 0, 0]) for e in range(b)]
        fjs = [int(feat_j[e, 0, 0]) for e in range(b)]
        d = self._dev(fis[0])[1].shape[-1]
        X11 = torch.stack([self._dev(f)[0] for f in fis + fjs]).reshape(2 * b, h, w, 3)
        X21 = torch.stack([self._cross_dev(fj, fi) for fi, fj in zip(fis, fjs)]
                          + [self._cross_dev(fi, fj) for fi, fj in zip(fis, fjs)]
                          ).reshape(2 * b, h, w, 3)
        D11 = torch.stack([self._dev(f)[1] for f in fis + fjs]).reshape(2 * b, h, w, d)
        D21 = torch.stack([self._dev(f)[1] for f in fjs + fis]).reshape(2 * b, h, w, d)
        idx, valid = matching.match(self.match_cfg, X11, X21, D11, D21)
        Qc = self._q_const(b)
        return idx[:b], idx[b:], valid[:b], valid[b:], Qc, Qc, Qc, Qc

    def _q_const(self, b: int):
        """(b, HW, 1) of the constant match confidence (cached per b)."""
        hit = self._q_cache.get(b)
        if hit is None:
            hit = torch.full((b, self.h * self.w, 1), self.conf_value,
                             dtype=torch.float32, device=self.device)
            self._q_cache[b] = hit
        return hit
