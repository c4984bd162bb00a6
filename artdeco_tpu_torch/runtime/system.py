"""End-to-end on-the-fly reconstruction system.

Port of ``artdeco_tpu/runtime/system.py``: one host process drives
track -> backend -> map per frame (``System.run``).  By default the
mapper-facing half (the backend's ``process_async`` and the mapper) runs on
a worker thread, overlapping tracking, with the hard-sync keyframe barrier
kept: everything the tracker reads is written on the main thread, so the
trajectory is the sequential schedule's.  Frames come from the native C++
loader (``runtime/native_loader.py``: decode, SLAM and map images on its
own threads) where it applies, else from a background thread that decodes
them and runs the camera transform; another thread uploads each SLAM image
from pinned memory a few frames ahead of tracking.

Streams: the worker shares the main thread's CUDA stream (the device's
default stream), so its work is ordered against tracking's without events
and no tensor handed between the threads needs ``record_stream``.  The
upload thread copies on a stream of its own and waits for each copy to land
before it hands the tensor over; the tensor is recorded on the default
stream, where it is used.  Work items hold value snapshots: Frames and
their tensors are never written in place (the keyframe store replaces
them), and poses are copies.

``MapperStage`` is the mapper half alone (keyframe ingest, loop-closure
rigid transforms, densify, training bursts, metrics): ``System`` drives it
with the backend's messages, and the mapper-only runs drive it with
``exact_mapper_messages``.

``--n_devices N`` (N > 1) trains the mapper keyframe-data-parallel over a
mesh of N devices and shards the backend's dense GN over its edges
(``System.enable_mesh``, ``parallel/``).  Not ported: the viewers and the
AOT prewarm machinery.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from artdeco_tpu_torch.device import float32_policy, resolve
from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.mapper import keyframe as KF
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.keyframe import make_device_keyframe
from artdeco_tpu_torch.mapper.scene_model import SceneModel
from artdeco_tpu_torch.vslam.backend import Backend
from artdeco_tpu_torch.vslam.frontend import Frontend
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore

METRIC_KEYS = ("PSNR", "SSIM", "LPIPS", "Render", "GS", "n_test_frames")


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


def rigid_transform_poses(pool: KF.KeyframePool, slam_T, TCkC, is_kf, mask):
    """Loop-closure pose recomputation at keyframe capacity: the mapper
    keyframes' new world->cam 4x4s from their SLAM keyframe poses (times
    the relative pose T_CkC for mapper frames), and the old and new
    cam->world for the Gaussians' rigid transform (identity where ``mask``
    is off).  Returns (new_Rt, new_c2w, old_c2w), each (cap, 4, 4)."""
    T_full = lie.sim3_mul(slam_T, TCkC)
    T7 = torch.where(is_kf[:, None], slam_T[:, :7], T_full[:, :7])
    new_Rt = lie.se3_matrix(lie.se3_inv(T7))
    eye = torch.eye(4, device=slam_T.device)
    m = mask[:, None, None]
    Rts = torch.where(m, KF.get_all_Rt(pool)[: slam_T.shape[0]], eye)
    new_safe = torch.where(m, new_Rt, eye)
    return new_Rt, torch.linalg.inv(new_safe), torch.linalg.inv(Rts)


class Runtimes:
    """Wall-clock stage counters (ms per call in ``summary``)."""

    def __init__(self):
        self.data: dict = {}

    def add(self, key: str, dt: float):
        acc = self.data.setdefault(key, [0.0, 0])
        acc[0] += dt
        acc[1] += 1

    def summary(self) -> dict:
        return {k: 1000.0 * v[0] / max(v[1], 1) for k, v in self.data.items()}


# Map-resolution frames the native loader's cache keeps: mapper messages
# refer to recent frames, and the upload thread runs a few frames ahead.
MAP_CACHE_FRAMES = 8


class MapCache:
    """The native loader's map images by frame id, for the last
    ``MAP_CACHE_FRAMES`` frames only.  The upload thread puts; the stream
    loop and the mapper take."""

    def __init__(self):
        self._items: dict = {}
        self._lock = threading.Lock()

    def put(self, frame_id: int, img) -> None:
        with self._lock:
            self._items[frame_id] = img
            while len(self._items) > MAP_CACHE_FRAMES:
                del self._items[next(iter(self._items))]

    def pop(self, frame_id: int):
        """The frame's image, or None when it is not (or no longer) kept."""
        with self._lock:
            return self._items.pop(frame_id, None)


class MapperStage:
    """Consumes mapper messages into a ``SceneModel`` on ``device``.

    ``dataset`` supplies map-resolution images when a message carries none
    usable; its ``K_map`` and map size set the scene's camera.
    ``slam_keyframes`` (the SLAM ``KeyframeStore``) is needed only for the
    loop-closure rigid transform a SLAM keyframe after frame 0 triggers.
    """

    def __init__(self, dataset, cfg: MapperConfig = MapperConfig(), *, device=None,
                 seed: int = 0, num_key_iterations: int = 30,
                 num_common_iterations: int = 0, noise=None,
                 slam_keyframes: Optional[KeyframeStore] = None,
                 rigid_transform_gaussians: bool = True):
        self.dataset = dataset
        self.cfg = cfg
        self.device = resolve(device)
        self.num_key_iterations = num_key_iterations
        self.num_common_iterations = num_common_iterations
        self.slam_keyframes = slam_keyframes
        self.rigid_transform_gaussians = rigid_transform_gaussians
        self.scene_model = SceneModel(dataset.W_map, dataset.H_map, dataset.K_map,
                                      cfg, device=self.device, seed=seed, noise=noise)
        self.mapper_index = 0
        self.related_frames: dict = {}   # slam keyframe index -> [mapper ids]
        self.mapper_meta: list = []      # per mapper frame bookkeeping
        self.rigid_transforms = 0        # loop-closure transforms of the scene
        self.start_time = time.time()
        self.n_frames = 0
        self.map_cache = MapCache()      # the native loader's map images
        # seconds and count of frames decoded again where no image came
        self.decode_s = [0.0, 0]

    def _map_image(self, m: dict, img_map):
        """The message's map-resolution image in [0, 1] and its info: the
        frame's device SLAM image when the resolutions match, else the
        image given, else the native loader's, else the dataset's frame
        decoded again."""
        frame_id = m["frame_id"]
        info = dict(self.dataset.infos[self.dataset.image_name_list[frame_id]])
        same_res = (self.dataset.H_map == self.dataset.H_slam
                    and self.dataset.W_map == self.dataset.W_slam)
        if same_res and m.get("img_dev") is not None:
            # the SLAM image is in [-1, 1]; the mapper trains on [0, 1]
            return (m["img_dev"] + 1.0) * 0.5, info
        if img_map is not None:
            return img_map, info
        cached = self.map_cache.pop(frame_id)
        if cached is not None:
            return cached, info
        t0 = time.time()
        original, info = self.dataset[frame_id]
        out = self.dataset.transform.to_map(original)
        self.decode_s[0] += time.time() - t0
        self.decode_s[1] += 1
        return out, info

    def handle(self, m: dict, img_map=None) -> dict:
        """One mapper message: ``ingest`` then ``train``.  Returns the
        burst's last metrics (empty when no burst ran)."""
        self.ingest(m, img_map)
        return self.train(m)

    def ingest(self, m: dict, img_map=None):
        """Register the message's keyframe (after the loop-closure rigid
        transform a SLAM keyframe after frame 0 brings) and densify if it is
        important.  Returns the new keyframe."""
        frame_id = m["frame_id"]
        last_kf_index = m["last_keyframe_index"]
        self.related_frames.setdefault(last_kf_index, []).append(self.mapper_index)
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
        self.mapper_meta.append(dict(last_keyframe_index=last_kf_index,
                                     is_slam_keyframe=m["is_slam_keyframe"],
                                     T_CkC=m["T_CkC"]))
        if m["is_slam_keyframe"] and frame_id > 0:
            self.rigid_transform_scene()
        self.scene_model.add_keyframe(kf, Rt_w2c)
        if m["is_important"]:
            self.scene_model.add_new_gaussians()
        self.mapper_index += 1
        self.n_frames += 1
        return kf

    def rigid_transform_scene(self):
        """Carry the pose graph's corrections into the mapper's keyframe
        poses and its Gaussians: one batched update at keyframe capacity."""
        if self.slam_keyframes is None:
            raise RuntimeError("a SLAM keyframe after frame 0 needs the SLAM keyframe "
                               "store (MapperStage(slam_keyframes=...))")
        sm = self.scene_model
        n = len(sm.keyframes)
        if n == 0:
            return
        cap = sm.cfg.keyframe_capacity
        dev = self.device
        ident8 = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=torch.float32, device=dev)
        slam_T = np.tile(ident8.cpu().numpy(), (cap, 1))
        is_kf = np.zeros(cap, bool)
        mask = np.zeros(cap, bool)
        rel_rows, rel = [], []
        for mapper_id in range(n):
            meta = self.mapper_meta[mapper_id]
            slam_T[mapper_id] = self.slam_keyframes.T_WC[meta["last_keyframe_index"]]
            is_kf[mapper_id] = meta["is_slam_keyframe"]
            mask[mapper_id] = True
            if meta["T_CkC"] is not None:
                rel_rows.append(mapper_id)
                rel.append(torch.as_tensor(meta["T_CkC"], dtype=torch.float32, device=dev))
        TCkC = ident8.repeat(cap, 1)
        if rel:
            TCkC[rel_rows] = torch.stack(rel)
        mask_t = torch.as_tensor(mask, device=dev)
        new_Rt, new_c2ws, old_c2ws = rigid_transform_poses(
            sm.pool, torch.as_tensor(slam_T, device=dev), TCkC,
            torch.as_tensor(is_kf, device=dev), mask_t)
        sm.set_keyframe_poses_masked(new_Rt, mask_t)
        if self.rigid_transform_gaussians:
            sm.rigid_transform_gs(old_c2ws, new_c2ws)
        self.rigid_transforms += 1

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


class _Prefetcher:
    """Background frame decode thread."""

    def __init__(self, dataset, depth: int = 4):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        for i in range(len(self.dataset)):
            self.q.put(self.dataset[i])
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item


class _UploadAhead:
    """SLAM-image upload ahead of tracking (up to ``depth`` frames).

    Each frame's SLAM image goes from pinned host memory to the device on
    this thread's own stream; the thread waits for the copy, binds the
    tensor to its frame (``runner.bind``, so the tracker never pulls the
    image back to find it) and yields (("slam_dev", tensor), info).  Call
    :meth:`close` when the consumer stops early."""

    def __init__(self, it, transform, device, runner=None, depth: int = 3):
        self.it = it
        self.transform = transform
        self.device = torch.device(device)
        self.bind = getattr(runner, "bind", None)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def close(self):
        """Stop the producer and drain queued items so it can exit."""
        self._stop = True
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break

    def _upload(self, original_image):
        if isinstance(original_image, tuple) and original_image[0] == "native":
            host = original_image[1]     # the native loader's SLAM image
        else:
            host = self.transform.to_slam(original_image)
        if self.stream is None:
            dev = torch.from_numpy(np.ascontiguousarray(host)).to(self.device)
        else:
            pinned = torch.from_numpy(np.ascontiguousarray(host)).pin_memory()
            with torch.cuda.stream(self.stream):
                dev = pinned.to(self.device, non_blocking=True)
            self.stream.synchronize()
            # used on the default stream from here on
            dev.record_stream(torch.cuda.default_stream(self.device))
        if self.bind is not None:
            self.bind(dev, host)
        return dev

    def _run(self):
        try:
            for original_image, info in self.it:
                if self._stop:
                    return
                dev = self._upload(original_image)
                while not self._stop:
                    try:
                        self.q.put((("slam_dev", dev), info), timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
        except Exception as e:  # surfaced to the consumer
            self.q.put(e)
            return
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item


class _MapperWorker:
    """Background consumer of the backend's work items, in message order:
    mapper-frame matching, dense points and the mapper.  Nothing here
    writes tracker-visible state.  The bounded queue is the backpressure;
    an exception surfaces on the next ``submit`` or on ``close``."""

    def __init__(self, system, depth: int = 4):
        self.system = system
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def submit(self, work: dict, img_map=None):
        if self.error is not None:
            err, self.error = self.error, None
            raise err
        self.q.put((work, img_map))

    def _run(self):
        while True:
            item = self.q.get()
            try:
                if item is None:
                    return
                work, img_map = item
                t0 = time.time()
                mm = self.system.backend.process_async(work)
                if mm is not None:
                    self.system._handle_mapper_msg(mm, img_map=img_map)
                self.system.runtimes.add("map", time.time() - t0)
            except Exception as e:  # surfaced on the next submit/close
                self.error = e
            finally:
                self.q.task_done()

    def close(self):
        self.q.put(None)
        self.t.join()
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def make_native_prefetcher(dataset):
    """The native C++ decode + resize pipeline where it applies, else None
    (the Python path then runs): the reference's rule (no undistortion
    remap, image paths on disk) and a machine that can build it
    (``native_loader.missing_toolchain``).  Once it applies, a failure to
    build or run it raises."""
    from artdeco_tpu_torch.runtime import native_loader

    paths = getattr(dataset, "image_paths", None)
    if (dataset.transform.mapx is not None or not paths or not os.path.isfile(paths[0])
            or native_loader.missing_toolchain() is not None):
        return None
    return native_loader.NativePrefetcher(paths, dataset.transform)


def stream_slam_images(dataset, use_native_loader: bool = True):
    """The host SLAM images ``System.run(use_native_loader=...)`` will
    track, in order: the native loader's where it applies, else
    ``to_slam``'s.  The oracle registers frames by these bytes."""
    native = make_native_prefetcher(dataset) if use_native_loader else None
    if native is None:
        for i in range(len(dataset)):
            yield dataset.transform.to_slam(dataset[i][0])
        return
    try:
        for _ in range(len(dataset)):
            yield native.get()[0]
    finally:
        native.close()


class System:
    """Single-host pipeline: track -> backend -> map, per frame, on
    ``device`` (default: the CUDA device).

    ``mapper_seed`` and ``noise`` seed the mapper's host randomness and its
    densification noise (``SceneModel``)."""

    def __init__(self, args, config: dict, dataset, runner,
                 mapper_cfg: Optional[MapperConfig] = None, retrieval=None, *,
                 device=None, mapper_seed: int = 0, noise=None):
        self.args = args
        self.config = config
        self.dataset = dataset
        self.device = resolve(device)
        float32_policy()
        self.auto_calib = self._maybe_auto_calibrate(args, dataset, runner)
        self.keyframes = KeyframeStore(dataset.H_slam, dataset.W_slam, K_slam=dataset.K_slam,
                                       device=self.device)
        self.frontend = Frontend(args, config, dataset, self.keyframes, runner,
                                 device=self.device)
        if retrieval is None:
            from artdeco_tpu_torch.vslam.retrieval import build_retrieval_database

            retrieval = build_retrieval_database(args, config, self.keyframes)
        self.backend = Backend(args, config, dataset, self.keyframes, runner,
                               retrieval=retrieval, device=self.device)
        self.mapper_cfg = mapper_cfg or MapperConfig(
            sh_degree=getattr(args, "sh_degree", 3),
            local_feat_dim=getattr(args, "local_feat_dim", 32),
            global_feat_dim=getattr(args, "global_feat_dim", 32),
            pyr_levels=getattr(args, "pyr_levels", 2),
        )
        self.mapper = MapperStage(
            dataset, self.mapper_cfg, device=self.device, seed=mapper_seed, noise=noise,
            num_key_iterations=getattr(args, "num_key_iterations", 30),
            num_common_iterations=getattr(args, "num_common_iterations", 0),
            slam_keyframes=self.keyframes,
            rigid_transform_gaussians=getattr(args, "rigid_transform_gaussians", True))
        n_dev = int(getattr(args, "n_devices", 1) or 1)
        if n_dev > 1:
            from artdeco_tpu_torch.parallel.mesh import make_mesh

            self.enable_mesh(make_mesh(n_dev, self.device))
        self.runtimes = Runtimes()
        self.start_time = None
        self.n_frames = 0
        self.frame_s: list = []     # host seconds per frame of the stream loop
        self.loader = None          # the frame source of the last run: "native" or "python"

    @property
    def scene_model(self) -> SceneModel:
        return self.mapper.scene_model

    def enable_mesh(self, mesh) -> None:
        """Run the multi-device path over ``mesh`` (``parallel/mesh.Mesh``,
        axis "dp", its first device the System's): the mapper trains one
        keyframe a slot each iteration and shards its full-frame renders,
        and the backend's dense GN shards its edges."""
        self.scene_model.enable_mesh(mesh)
        self.backend.factor_graph.enable_mesh(mesh, "dp")

    @property
    def mapper_index(self) -> int:
        return self.mapper.mapper_index

    @staticmethod
    def _maybe_auto_calibrate(args, dataset, runner):
        """Focal estimate from the first frame's mono pointmap when the
        dataset's intrinsics are a guess (``calib_is_guess``).  Returns
        what it did, or None when it did not run: the focal guessed and
        the one estimated (original-image pixels) and the K_slam kept.  A
        degenerate estimate keeps the guess with a warning, as in the JAX
        package; any other failure raises."""
        if not getattr(dataset, "calib_is_guess", False):
            return None
        if not getattr(args, "auto_calib", True) or not hasattr(runner, "inference_mono"):
            return None
        from artdeco_tpu_torch.geometry.calibration import estimate_focal_weiszfeld

        out = {"guess": float(dataset.transform.K_best[0, 0])}
        img, _ = dataset[0]
        img_slam = torch.as_tensor(dataset.transform.to_slam(img), device=runner.device)
        X, C, _, _ = runner.inference_mono(img_slam)
        conf = C[0][:, 0].cpu().numpy()
        # keep the most confident 70 % (>= so a constant confidence keeps all)
        valid = torch.as_tensor(conf >= np.quantile(conf, 0.3), device=X.device)
        f_slam = float(estimate_focal_weiszfeld(X[0], valid, dataset.H_slam, dataset.W_slam))
        # scale_slam_w is original / SLAM pixels
        out["estimate"] = f_slam * dataset.transform.scale_slam_w
        if np.isfinite(f_slam) and f_slam > 1.0:
            dataset.recalibrate_focal(out["estimate"])
            out["applied"] = True
        else:
            import warnings

            out["applied"] = False
            out["error"] = f"degenerate focal estimate {f_slam}"
            warnings.warn(f"auto-calibration failed, keeping guess: {out['error']}")
        out["K_slam"] = np.asarray(dataset.K_slam).copy()
        return out

    # -- mapper messages ----------------------------------------------------
    def _handle_mapper_msg(self, m: dict, img_map=None):
        return self.mapper.handle(m, img_map)

    # -- main loop ----------------------------------------------------------
    def run(self, max_frames: Optional[int] = None, progress: bool = True,
            use_native_loader: bool = True, overlap: Optional[bool] = None):
        """Stream the dataset through track -> backend -> map.

        ``use_native_loader``: frames come from the native C++ loader where
        it applies (``make_native_prefetcher``), else from the Python path;
        ``self.loader`` says which ran.  ``overlap`` (default:
        args.async_pipeline, else True) runs the mapper-facing half on a
        worker thread; the trajectory is the same either way, only the wall
        clock differs."""
        if overlap is None:
            overlap = bool(getattr(self.args, "async_pipeline", True))
        self.start_time = time.time()
        native = make_native_prefetcher(self.dataset) if use_native_loader else None
        self.loader = "python" if native is None else "native"
        if native is not None:
            it = self._native_frames(native)
        else:
            it = _Prefetcher(self.dataset)
        it = _UploadAhead(it, self.dataset.transform, self.device, runner=self.frontend.runner)
        bar = None
        if progress:
            try:
                from tqdm import tqdm

                bar = tqdm(total=len(self.dataset), desc="artdeco-torch")
            except ImportError:
                bar = None
        profile_dir = getattr(self.args, "profile_dir", "") or ""
        prof = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(profile_dir))
            prof.start()
            annotate = torch.profiler.record_function
        else:
            annotate = lambda name: contextlib.nullcontext()   # noqa: E731
        worker = _MapperWorker(self) if overlap else None
        try:
            self._stream_loop(it, bar, max_frames, annotate, worker)
        finally:
            it.close()
            if worker is not None:
                worker.close()
            if native is not None:
                it.t.join()     # the upload thread stops reading the loader first
                native.close()
            if prof is not None:
                prof.stop()
        if bar is not None:
            bar.close()
        return self

    def _native_frames(self, native):
        """(("native", slam), info) per frame from the native loader; each
        frame's map image goes to the mapper's ``map_cache``."""
        for i in range(len(self.dataset)):
            slam, mp = native.get()
            info = dict(self.dataset.infos[self.dataset.image_name_list[i]])
            if self.dataset.Twc_gt is not None:
                info["Twc_gt"] = self.dataset.Twc_gt[i]
            self.mapper.map_cache.put(i, mp)
            yield ("native", slam), info

    def _stream_loop(self, it, bar, max_frames, annotate, worker=None):
        for original_image, info in it:
            t_frame = t0 = time.time()
            with annotate("frontend.track"):
                msg = self.frontend.process_frame(original_image, info)
            self.runtimes.add("track", time.time() - t0)
            if msg is not None:
                t0 = time.time()
                with annotate("backend.sync"):
                    work = self.backend.process_sync(msg)
                self.runtimes.add("backend", time.time() - t0)
                if work is not None:
                    if worker is not None:
                        # the native loader's map image of the current frame;
                        # taken now, before the cache window moves past it
                        worker.submit(work, self.mapper.map_cache.pop(msg["frame_id"]))
                    else:
                        t0 = time.time()
                        with annotate("mapper.step"):
                            mapper_msg = self.backend.process_async(work)
                            if mapper_msg is not None:
                                self._handle_mapper_msg(mapper_msg)
                        self.runtimes.add("map", time.time() - t0)
            self.n_frames += 1
            self.frame_s.append(time.time() - t_frame)
            if bar is not None:
                bar.update(1)
                # the Gaussian count is a device readback: skipped while the
                # worker overlaps, where it would wait for the mapper
                gs = "?" if worker is not None else self.scene_model.n_active_gaussians
                bar.set_postfix_str(f"kf={len(self.keyframes)} gs={gs} "
                                    f"lost={self.frontend.lost_number}", refresh=False)
            if max_frames is not None and self.n_frames >= max_frames:
                break

    # -- outputs --------------------------------------------------------------
    def save(self, out_dir: str) -> dict:
        """Trajectories, lost share, config and trajectory evaluation under
        ``out_dir/slam``; the scene export (``SceneModel.save``); and
        ``run_metadata.json``.  Returns the metadata."""
        from artdeco_tpu_torch.dataio.tum_io import save_tum_trajectory
        from artdeco_tpu_torch.eval.trajectory import evaluate_trajectory

        os.makedirs(out_dir, exist_ok=True)
        slam_dir = os.path.join(out_dir, "slam")
        os.makedirs(slam_dir, exist_ok=True)
        est = self.frontend.estimated_trajectory()
        kf_traj = self.frontend.keyframe_trajectory()
        if len(est):
            save_tum_trajectory(os.path.join(slam_dir, "frames.txt"), est[:, 0], est[:, 1:8])
        if len(kf_traj):
            save_tum_trajectory(os.path.join(slam_dir, "keyframes.txt"),
                                kf_traj[:, 0], kf_traj[:, 1:8])
        lost_pct = self.frontend.lost_number / max(len(self.dataset), 1)
        with open(os.path.join(slam_dir, "lost_percentage.txt"), "w") as f:
            f.write(str(lost_pct))
        with open(os.path.join(slam_dir, "config.json"), "w") as f:
            json.dump(self.config, f, indent=4, default=str)
        gt = np.asarray(self.frontend.frames_Twc_gt)
        eval_out = {}
        if len(gt) > 2 and len(est) > 2:
            eval_out = evaluate_trajectory(slam_dir, "evaluate_frames.json", est, gt,
                                           max_dt=0.05)

        dt = time.time() - self.start_time if self.start_time else 0.0
        scene_metrics = self.scene_model.save(out_dir, reconstruction_time=dt,
                                              n_frames=self.n_frames)
        metadata = {
            "time": dt,
            "FPS": self.n_frames / max(dt, 1e-9),
            "n_frames": self.n_frames,
            "n_keyframes": len(self.keyframes),
            "n_gaussians": int(self.scene_model.n_active_gaussians),
            "runtimes_ms": self.runtimes.summary(),
            "metrics": {k: v for k, v in scene_metrics.items() if k in METRIC_KEYS},
            "trajectory": eval_out,
        }
        with open(os.path.join(out_dir, "run_metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2, default=str)
        return metadata

    def finetune(self, n_epochs: int):
        """Post-stream finetuning epochs."""
        self.scene_model.enable_inference_mode()
        for _ in range(n_epochs):
            self.scene_model.finetune_epoch()
