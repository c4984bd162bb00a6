"""Backend: loop closure, global optimization, dense points for the mapper.

Port of ``artdeco_tpu/vslam/backend.py``.  ``process_sync`` does what the
next tracked frame depends on (relocalization, the keyframe's global
optimization); ``process_async`` builds the mapper message (mapper-frame
matching, dense points) and writes nothing the tracker reads, so the
overlapped ``System`` runs it on its worker thread; ``process`` runs both.

The JAX package's four jitted helpers are plain tensor functions here.
``dense_point``'s scatter has duplicate targets (many pixels of the last
keyframe match one pixel of the keyframe): the points written there are
equal, their confidences are not.  The JAX package on the CPU keeps the
last writer; a CUDA scatter keeps any.  The port picks the last writer
explicitly (the largest source index per target), so the card, the CPU
and the JAX package agree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from artdeco_tpu_torch import trace
from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.geometry import projection as proj
from artdeco_tpu_torch.vslam.frame import Frame, KeyframeStyle
from artdeco_tpu_torch.vslam.global_opt import FactorGraph
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from artdeco_tpu_torch.vslam.retrieval import RetrievalDatabase


def host_tokens(feat) -> np.ndarray:
    """The first image's encoder tokens as one explicit host float32 copy
    (the retrieval database runs on the host; a model's ``feat`` is a
    device tensor, the oracle's a host token)."""
    return feat[0].detach().to(device="cpu", dtype=torch.float32, copy=True).numpy()


def dense_point(idx, Xkk, Twk, Twl, K, height: int, width: int, valid_pixel: float = 3.0):
    """The mapper's pointmap of keyframe k and its confidence from the
    matches ``idx`` (HW,) of the last keyframe l's pixels into k.

    Returns (point (H, W, 3), conf (H, W)): every pixel of k keeps its
    ray-constrained point; a pixel that some pixel of l matched gets the
    confidence of the last such match (the largest index of l), 1 when it
    reprojects within ``valid_pixel`` and decaying beyond; others get 0."""
    H, W = height, width
    Tlk = lie.sim3_mul(lie.sim3_inv(Twl), Twk)
    Xkk_calib = proj.constrain_points_to_ray((H, W), Xkk, K)
    idx = idx.long()
    Xkk_m = Xkk_calib[idx]
    Xkl = lie.sim3_act(Tlk, Xkk_m)
    z = torch.clamp_min(Xkl[:, 2:3], 1e-9)
    u = K[0, 0] * Xkl[:, 0:1] / z + K[0, 2]
    v = K[1, 1] * Xkl[:, 1:2] / z + K[1, 2]
    uv = proj.get_pixel_coords((H, W), device=Xkk.device)
    resi = torch.linalg.vector_norm(torch.cat([u, v], -1) - uv, dim=-1)
    conf_valid = torch.where(resi < valid_pixel, 1.0, 1.0 / (resi - valid_pixel + 1.0))

    T_kw = lie.se3_inv(Twk[:7])
    Xk_map_matched = lie.se3_act(T_kw, lie.sim3_act(Twk, Xkk_m))
    Xk_map_default = lie.se3_act(T_kw, lie.sim3_act(Twk, Xkk_calib))
    # the last writer per target: the largest source index that hits it
    src = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((H * W,), -1, dtype=torch.int64, device=idx.device)
    winner = winner.scatter_reduce(0, idx, src, reduce="amax")
    hit = winner >= 0
    w = torch.clamp_min(winner, 0)
    point = torch.where(hit[:, None], Xk_map_matched[w], Xk_map_default)
    conf = torch.where(hit, conf_valid[w], 0.0)
    return point.reshape(H, W, 3), conf.reshape(H, W)


def keyframe_point(Xkk, avg_conf, K, height: int, width: int):
    """First-keyframe mapper payload (no last keyframe, no matches): the
    ray-constrained pointmap and the thresholded confidence."""
    point = proj.constrain_points_to_ray((height, width), Xkk, K)
    conf = (avg_conf.reshape(-1) > 1.5).float()
    return point.reshape(height, width, 3), conf.reshape(height, width)


def rel_sim3(T_WCl, T_WCk):
    return lie.sim3_mul(lie.sim3_inv(T_WCl), T_WCk)


def cross_writeback(T_WCk, T_WCl, Xlk):
    """The last keyframe's points from the cross-prediction ``Xlk``, in
    the last keyframe's camera."""
    return lie.sim3_act(rel_sim3(T_WCl, T_WCk), Xlk)


class Backend(trace.Timed):
    """Relocalization, per-keyframe global optimization and the mapper
    messages.  ``timers`` sums wall time per stage ("bkd.*", and
    "backend.sync" a message); with ``sync_timing`` the device is
    synchronised at each stage boundary (the factor graph's timers too).
    Each message is its frame's request of the tracer (``stream``,
    ``frame_id``), and so is the work item it makes."""

    def __init__(self, args, config: dict, dataset, keyframes: KeyframeStore, runner,
                 retrieval: Optional[RetrievalDatabase] = None, *, device=None):
        self.args = args
        self.config = config
        self.dataset = dataset
        self.keyframes = keyframes
        self.runner = runner
        self.device = resolve(device)
        self.H_slam, self.W_slam = dataset.H_slam, dataset.W_slam
        self.K_slam = torch.as_tensor(np.asarray(dataset.K_slam, np.float32),
                                      device=self.device)
        self.num_GBA = getattr(args, "num_GBA", 1)
        self.factor_graph = FactorGraph(config, runner, keyframes, dataset.K_slam,
                                        (self.H_slam, self.W_slam), device=self.device)
        self.retrieval = retrieval or RetrievalDatabase(config)
        self.timers = trace.Timers()
        self.pair_matches = 0    # match_asymmetric calls (one K3 launch each)

    @trace.Timed.sync_timing.setter
    def sync_timing(self, on: bool) -> None:
        self.timers.sync_timing = self.factor_graph.sync_timing = bool(on)

    def _retrieve(self, feat, add_after_query: bool) -> list:
        rc = self.config["retrieval"]
        return self.retrieval.update(host_tokens(feat), add_after_query=add_after_query,
                                     k=rc["k"], min_thresh=rc["min_thresh"])

    # -- message dispatch --------------------------------------------------
    def process(self, msg: dict) -> Optional[dict]:
        work = self.process_sync(msg)
        return self.process_async(work) if work is not None else None

    def process_sync(self, msg: dict) -> Optional[dict]:
        """The tracker-visible half: relocalization or the keyframe's global
        optimization.  Returns a work item of value snapshots, or None."""
        with self.timers.span("backend.sync", request=(msg.get("stream"), msg["frame_id"])):
            return self._process_sync(msg)

    def _process_sync(self, msg: dict) -> Optional[dict]:
        style = msg["keyframe_style"]
        common = dict(is_test=msg["is_test"], is_important=msg["is_important"],
                      focal=msg["focal"], timestamp=msg["timestamp"],
                      frame_id=msg["frame_id"], stream=msg.get("stream"))
        if style == int(KeyframeStyle.LOST):
            frame = msg["frame"]
            X, C, feat, pos = self.runner.inference_mono(frame.img)
            frame = frame.update_pointmap(X[0], C[0]).update_pointmap(X[1], C[1])
            success, lc_inds = self.relocalization(frame, feat, pos)
            if not success:
                return None
            n_kf = len(self.keyframes)
            last_keyframe = self.keyframes[n_kf - 2] if n_kf > 1 else None
            embeddings = None
            if last_keyframe is not None:
                embeddings = (self.keyframes.get_embedding(n_kf - 1),
                              self.keyframes.get_embedding(n_kf - 2))
            return dict(kind="reloc", keyframe=self.keyframes[n_kf - 1],
                        last_keyframe=last_keyframe, kf_index=n_kf - 1,
                        embeddings=embeddings, lc_inds=lc_inds, **common)
        if style == int(KeyframeStyle.KEYFRAME):
            lc_inds, idx_k2l, keyframe, last_keyframe = self.global_optimization(
                msg["keyframe_id"], track_match=msg.get("track_match"))
            return dict(kind="keyframe", keyframe=keyframe, last_keyframe=last_keyframe,
                        kf_index=msg["keyframe_id"], idx_k2l=idx_k2l, lc_inds=lc_inds,
                        **common)
        if style == int(KeyframeStyle.MAPPER_FRAME):
            kf_id = msg["keyframe_id"]
            return dict(kind="mapper_frame", frame=msg["frame"],
                        last_keyframe=self.keyframes[kf_id], kf_index=kf_id,
                        embedding_j=self.keyframes.get_embedding(kf_id), **common)
        return None

    def process_async(self, work: dict) -> Optional[dict]:
        """The mapper-facing half: the mapper message of a work item."""
        with trace.request((work["stream"], work["frame_id"])):
            return self._process_async(work)

    def _process_async(self, work: dict) -> Optional[dict]:
        kind = work["kind"]
        common = dict(is_test=work["is_test"], is_important=work["is_important"],
                      focal=work["focal"], timestamp=work["timestamp"])
        if kind == "reloc":
            keyframe, last_keyframe = work["keyframe"], work["last_keyframe"]
            idx_k2l = None
            if last_keyframe is not None:
                ei, ej = work["embeddings"]
                idx_k2l = self.runner.match_asymmetric(
                    keyframe.img, last_keyframe.img, embeddings_i=ei, embeddings_j=ej)[0]
                self.pair_matches += 1
            return self.prepare_for_mapper(
                keyframe, last_keyframe, work["kf_index"], idx_k2l,
                loop_keyframe_index=work["lc_inds"], is_slam_keyframe=True,
                img_dev=keyframe.img, **common)
        if kind == "keyframe":
            return self.prepare_for_mapper(
                work["keyframe"], work["last_keyframe"], work["kf_index"], work["idx_k2l"],
                loop_keyframe_index=work["lc_inds"], is_slam_keyframe=True,
                img_dev=work["keyframe"].img, **common)
        if kind == "mapper_frame":
            frame: Frame = work["frame"]
            last_keyframe = work["last_keyframe"]
            idx_k2l, _, Xkk, Ckk = self.runner.match_asymmetric(
                frame.img, last_keyframe.img, embeddings_j=work["embedding_j"])[:4]
            self.pair_matches += 1
            frame = frame.update_pointmap(Xkk, Ckk)
            return self.prepare_for_mapper(frame, last_keyframe, work["kf_index"], idx_k2l,
                                           img_dev=frame.img, **common)
        return None

    # -- global optimization -------------------------------------------------
    def global_optimization(self, idx: int, n_consec: int = None, track_match: dict = None):
        """Keyframe ``idx``: its pointmap update, retrieval, candidate edges,
        one GN solve, and the last keyframe's pointmap refresh.
        ``track_match`` is the frontend's decode of this keyframe's pair
        (``CameraTracker.take_last_pair``), reused instead of matching the
        pair again.  Returns (lc_inds, idx_k2l, keyframe, last_keyframe)."""
        n_consec = n_consec if n_consec is not None else self.num_GBA
        span, dev = self.timers.span, self.device
        with span("bkd.match_asym", dev):
            keyframe = self.keyframes[idx]
            last_keyframe = self.keyframes[idx - 1] if idx > 0 else None
            idx_k2l = Xlk = Clk = None
            tm = track_match
            if last_keyframe is not None:
                if tm is not None and tm.get("kind") == "pair" and tm.get("last_idx") == idx - 1:
                    idx_k2l, Xkk, Ckk = tm["idx"], tm["Xkk"], tm["Ckk"]
                    Xlk, Clk, feat_k, pos_k = tm["Xlk"], tm["Clk"], tm["feat"], tm["pos"]
                else:
                    (idx_k2l, _, Xkk, Ckk, _, Xlk, Clk, _, feat_k, pos_k
                     ) = self.runner.match_asymmetric(
                        keyframe.img, last_keyframe.img,
                        embeddings_j=self.keyframes.get_embedding(idx - 1))
                    self.pair_matches += 1
            elif tm is not None and tm.get("kind") == "mono":
                Xkk, Ckk, feat_k, pos_k = tm["X"][0], tm["C"][0], tm["feat"], tm["pos"]
            else:
                Xm, Cm, feat_k, pos_k = self.runner.inference_mono(keyframe.img)
                Xkk, Ckk = Xm[0], Cm[0]
        with span("bkd.pointmap_update", dev):
            self.keyframes.put_embedding(idx, feat_k, pos_k)
            keyframe = keyframe.update_pointmap(Xkk, Ckk)
            self.keyframes[idx] = keyframe

        # candidate edges: consecutive + retrieval
        with span("bkd.retrieval", dev):
            kf_idx = [idx - 1 - j for j in range(min(n_consec, idx))]
            retrieval_inds = self._retrieve(feat_k, add_after_query=True)
        kf_idx += retrieval_inds
        lc_inds = set(retrieval_inds)
        lc_inds.add(idx)
        kf_list = sorted(set(kf_idx) - {idx})
        with span("bkd.add_factors", dev):
            if kf_list:
                self.factor_graph.add_factors(kf_list, [idx] * len(kf_list),
                                              self.config["local_opt"]["min_match_frac"])
        with span("bkd.solve_GN", dev):
            self.factor_graph.solve_GN_calib()

        # refresh the last keyframe's pointmap with the cross-prediction
        with span("bkd.writeback", dev):
            keyframe = self.keyframes[idx]
            last_keyframe = self.keyframes[idx - 1] if idx > 0 else None
            if last_keyframe is not None and Xlk is not None:
                Xll = cross_writeback(keyframe.T_WC, last_keyframe.T_WC, Xlk)
                last_keyframe = last_keyframe.update_pointmap(Xll, Clk)
                self.keyframes[idx - 1] = last_keyframe
        return lc_inds, idx_k2l, keyframe, last_keyframe

    # -- relocalization --------------------------------------------------------
    def relocalization(self, frame: Frame, feat, pos):
        """A lost frame: append it as a keyframe, retrieve candidates, verify
        with a strict two-way match (undo on failure), take the first
        candidate's pose and solve.  Returns (success, lc_inds).

        The frame is appended before the query (the JAX package appends it
        after), so that a Pi3 accurate matcher finds the query's image under
        its keyframe id; the retrieval query itself reads no keyframe."""
        idx = self.keyframes.append(frame)
        retrieval_inds = self._retrieve(feat, add_after_query=False)
        if not retrieval_inds:
            self.keyframes.pop_last()
            return False, set()
        self.keyframes.put_embedding(idx, feat, pos)
        ok = self.factor_graph.add_factors(
            list(retrieval_inds), [idx] * len(retrieval_inds),
            self.config["reloc"]["min_match_frac"], is_reloc=self.config["reloc"]["strict"])
        if not ok:
            self.keyframes.pop_last()
            return False, set()
        self._retrieve(feat, add_after_query=True)
        self.keyframes.T_WC[idx] = self.keyframes.T_WC[retrieval_inds[0]].copy()
        self.factor_graph.solve_GN_calib()
        return True, set(retrieval_inds)

    # -- dense points for the mapper ---------------------------------------------
    def compute_dense_point(self, keyframe: Frame, last_keyframe: Frame, idx_k2l,
                            valid_pixel: float = 3.0):
        return dense_point(idx_k2l[0], keyframe.X_canon, keyframe.T_WC, last_keyframe.T_WC,
                           self.K_slam, self.H_slam, self.W_slam, valid_pixel)

    def prepare_for_mapper(self, keyframe: Frame, last_keyframe, kf_index, idx_k2l,
                           is_test=False, is_important=False, loop_keyframe_index=None,
                           is_slam_keyframe=False, focal=None, timestamp=0.0,
                           img_dev=None) -> dict:
        """The mapper message: point_map, point_conf and T_CkC are device
        tensors; ``img_dev`` is the frame's SLAM image on the device."""
        if last_keyframe is None or idx_k2l is None:
            point, conf = keyframe_point(keyframe.X_canon, keyframe.get_average_conf(),
                                         self.K_slam, self.H_slam, self.W_slam)
            T_CkC = None
        else:
            point, conf = self.compute_dense_point(keyframe, last_keyframe, idx_k2l)
            T_CkC = rel_sim3(last_keyframe.T_WC, keyframe.T_WC)
        return {
            "is_test": is_test,
            "is_important": is_important,
            "T_WC": keyframe.T_WC.detach().cpu().numpy(),
            "frame_id": keyframe.frame_id,
            "timestamp": timestamp,
            "point_map": point,
            "point_conf": conf,
            "is_slam_keyframe": is_slam_keyframe,
            "loop_keyframe_index": loop_keyframe_index or set(),
            "T_CkC": T_CkC,
            "last_keyframe_index": kf_index,
            "focal": focal,
            "img_dev": img_dev,
        }
