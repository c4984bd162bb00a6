"""The mapper half of the streaming system.

Port of the mapper stage of ``artdeco_tpu/runtime/system.py``:
``MapperStage.handle`` is ``System._handle_mapper_msg`` (keyframe ingest,
densify on important frames, a training burst) and ``MapperStage.metrics``
is the metric part of ``System.save``.  It takes the backend's mapper
message dicts unchanged, so the later port of ``System`` drives it as it
is.  Tracking, the backend and loop-closure rigid transforms are not
ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.keyframe import make_device_keyframe
from artdeco_tpu_torch.mapper.scene_model import SceneModel

METRIC_KEYS = ("PSNR", "SSIM", "Render", "GS", "n_test_frames")


def se3_w2c_matrix_np(T_wc7: np.ndarray) -> np.ndarray:
    """4x4 world->cam from a 7-vector [t, q_xyzw] cam->world pose."""
    t = np.asarray(T_wc7[:3], np.float32)
    x, y, z, w = np.asarray(T_wc7[3:7], np.float64)
    R = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def plane_pointmap(T_wc: np.ndarray, K: np.ndarray, h: int, w: int,
                   z_plane: float = 2.0) -> np.ndarray:
    """(h, w, 3) camera-frame points of the plane z_w = z_plane seen from
    the Sim(3) pose T_wc = [t, q_xyzw, s]: the oracle's exact pointmap
    (``artdeco_tpu/models/oracle.py`` ``OracleRunner._pointmap``)."""
    x, y, z, qw = T_wc[3:7]
    R = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - qw * z), 2 * (x * z + qw * y)],
        [2 * (x * y + qw * z), 1 - 2 * (x * x + z * z), 2 * (y * z - qw * x)],
        [2 * (x * z - qw * y), 2 * (y * z + qw * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    s, t = T_wc[7], T_wc[0:3]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                     np.ones_like(u)], -1)
    d_w = s * (rays @ R.T)
    sc = (z_plane - t[2]) / d_w[..., 2]
    return (rays * sc[..., None]).astype(np.float32)


def exact_mapper_messages(dataset, important_every: int = 2,
                          z_plane: float = 2.0, conf: float = 5.0):
    """The mapper messages the backend emits for a plane scene when
    tracking is exact: ground-truth poses, oracle pointmaps at SLAM
    resolution with constant confidence.  Frame i is important when
    ``i % important_every == 0`` or it is a test frame (as the frontend
    marks them); only frame 0 is a SLAM keyframe."""
    K = np.asarray(dataset.K_slam, np.float32)
    for i, name in enumerate(dataset.image_name_list):
        is_test = bool(dataset.infos[name]["is_test"])
        T_wc = np.concatenate([np.asarray(dataset.Twc_gt[i], np.float32),
                               np.ones(1, np.float32)])
        yield {
            "is_test": is_test,
            "is_important": i % important_every == 0 or is_test,
            "T_WC": T_wc,
            "frame_id": i,
            "timestamp": float(dataset.timestamp[i]),
            "point_map": plane_pointmap(T_wc, K, dataset.H_slam, dataset.W_slam,
                                        z_plane),
            "point_conf": np.full((dataset.H_slam, dataset.W_slam), conf, np.float32),
            "is_slam_keyframe": i == 0,
            "loop_keyframe_index": set(),
            "T_CkC": None,
            "last_keyframe_index": 0,
            "focal": float(K[0, 0]),
            "img_dev": None,
        }


class MapperStage:
    """Consumes mapper messages into a ``SceneModel`` on ``device``.

    ``dataset`` supplies map-resolution images (``dataset[frame_id]`` then
    ``dataset.transform.to_map``) when a message carries none; its
    ``K_map`` and map size set the scene's camera.
    """

    def __init__(self, dataset, cfg: MapperConfig = MapperConfig(), *, device,
                 seed: int = 0, num_key_iterations: int = 30,
                 num_common_iterations: int = 0, noise=None):
        self.dataset = dataset
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_key_iterations = num_key_iterations
        self.num_common_iterations = num_common_iterations
        self.scene_model = SceneModel(dataset.W_map, dataset.H_map, dataset.K_map,
                                      cfg, device=self.device, seed=seed, noise=noise)
        self.mapper_index = 0
        self.start_time = time.time()
        self.n_frames = 0

    def _map_image(self, m: dict, img_map):
        frame_id = m["frame_id"]
        info = dict(self.dataset.infos[self.dataset.image_name_list[frame_id]])
        if img_map is not None:
            return img_map, info
        same_res = (self.dataset.H_map == self.dataset.H_slam
                    and self.dataset.W_map == self.dataset.W_slam)
        if same_res and m.get("img_dev") is not None:
            return m["img_dev"], info
        original, info = self.dataset[frame_id]
        return self.dataset.transform.to_map(original), info

    def handle(self, m: dict, img_map=None) -> dict:
        """One mapper message: ``ingest`` then ``train``.  Returns the
        burst's last metrics (empty when no burst ran)."""
        self.ingest(m, img_map)
        return self.train(m)

    def ingest(self, m: dict, img_map=None):
        """Register the message's keyframe and densify if it is important.
        Returns the new keyframe."""
        frame_id = m["frame_id"]
        if m["is_slam_keyframe"] and frame_id > 0:
            raise NotImplementedError(
                "loop-closure rigid transforms of the scene need the port of "
                "geometry/lie.py; feed SLAM keyframes only at frame 0")
        img_map, info = self._map_image(m, img_map)
        Rt_w2c = se3_w2c_matrix_np(np.asarray(m["T_WC"], np.float32)[:7])
        kf = make_device_keyframe(
            index=self.mapper_index,
            global_frame_id=frame_id,
            image=img_map,
            point_map=m["point_map"],
            point_conf=m["point_conf"],
            is_test=m["is_test"],
            is_slam_keyframe=m["is_slam_keyframe"],
            device=self.device,
            pyr_levels=self.cfg.pyr_levels,
            image_name=info.get("name", f"frame_{frame_id:06d}"),
            timestamp=m["timestamp"],
        )
        self.scene_model.add_keyframe(kf, Rt_w2c)
        if m["is_important"]:
            self.scene_model.add_new_gaussians()
        self.mapper_index += 1
        self.n_frames += 1
        return kf

    def train(self, m: dict) -> dict:
        """The message's training burst (key or common iterations)."""
        n_iters = (self.num_key_iterations if m["is_important"]
                   else self.num_common_iterations)
        if not n_iters:
            return {}
        return self.scene_model.optimization_loop(n_iters, m["is_important"]) or {}

    def metrics(self) -> dict:
        """The scene metrics ``System.save`` reports: test-frame PSNR, SSIM,
        visible and active Gaussian counts, plus run totals."""
        sm = self.scene_model
        ev = sm.evaluate()
        dt = time.time() - self.start_time
        return {
            "time": dt,
            "FPS": self.n_frames / max(dt, 1e-9),
            "n_frames": self.n_frames,
            "n_keyframes": len(sm.keyframes),
            "n_gaussians": sm.n_active_gaussians,
            "metrics": {k: v for k, v in ev.items() if k in METRIC_KEYS},
        }
