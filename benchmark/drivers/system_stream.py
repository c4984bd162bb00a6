"""Driver: the program's ``System`` stream loop with the oracle front end.

Set-up draws the mix's stream from the seed, registers every frame with
``OracleRunner`` (the stand-in for a perfectly trained MASt3R over the
plane scene), builds ``System`` with the configuration's arguments,
config and mapper sizes, and runs the mix's warm-up frames through the
same loop as the window, then drains the mapper and the device.

The loop is ``System.run``'s, one frame at a time, closed: the next frame
is handed over when the last returns.  The SLAM image of each frame is
uploaded ahead on the program's upload thread (``_UploadAhead``); the main
thread tracks it (``Frontend.process_frame``), runs the backend's
synchronous half (``Backend.process_sync``) where the frame made a
message, and submits the work to the mapper's worker thread
(``_MapperWorker``, queue depth 4).  A frame's time runs from asking for it
to the return of its last call.

The check compares the program's trajectory, as ``System.save`` writes it
(``Frontend.estimated_trajectory`` and ``keyframe_trajectory``: keyframe
poses after the pose-graph GN), with the generator's exact poses; the
control puts those poses, computed in bfloat16, in the program's place.
"""

from __future__ import annotations

import copy
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.harness import Window, log, sync
from benchmark.reference import poses as P
from benchmark.traffic import stream


def stream_dataset(args, frames: np.ndarray, poses: np.ndarray):
    """The program's synthetic dataset type serving ``frames`` (n, H, W, 3)
    uint8 with ground truth ``poses``: the same camera model (focal 0.8 *
    width), SLAM and map transforms; timestamps are frame indices."""
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset

    class StreamDataset(SyntheticDataset):
        def __getitem__(self, index):
            info = dict(self.infos[self.image_name_list[index]])
            info["Twc_gt"] = self.Twc_gt[index]
            return frames[index], info

    n, h, w, _ = frames.shape
    ds = StreamDataset(args, n_frames=n, width=w, height=h)
    ds.Twc_gt = poses
    return ds


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device, tracer):
        t0 = time.perf_counter()
        from artdeco_tpu_torch.mapper.config import MapperConfig
        from artdeco_tpu_torch.models.oracle import OracleRunner
        from artdeco_tpu_torch.runtime import system as S

        self.setup_split = {"imports": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.device, self.tracer, self.mix, self.seed = device, tracer, mix, seed
        self.n_warm = int(mix["warmup_frames"])
        n = self.n_warm + int(mix["window_frames_max"])
        self.gt = stream.trajectory(mix, seed, n)
        frames = stream.frames(mix, seed, self.gt, device, host=True,
                               batch=max(1, 8_000_000 // (mix["width"] * mix["height"])))
        args = types.SimpleNamespace(**config["args"])
        cfg = copy.deepcopy(config["system"])
        ds = stream_dataset(args, frames, self.gt)
        self.setup_split["generate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"],
                              z_plane=float(mix["plane_z"]), device=device)
        mem0 = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0

        def register(i):
            T = np.ones(8, np.float32)
            T[:7] = self.gt[i]
            runner.register(ds.transform.to_slam(frames[i]), i, T)

        with ThreadPoolExecutor(max_workers=int(config.get("register_threads", 6))) as ex:
            list(ex.map(register, range(n)))
        sync(device)
        self.oracle_bytes = (torch.cuda.memory_allocated(device) - mem0
                             if device.type == "cuda" else 0)
        self.setup_split["register"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.system = S.System(args, cfg, ds, runner, mapper_cfg=MapperConfig(**config["mapper"]),
                               device=device, mapper_seed=seed % (2 ** 31))
        self.worker = S._MapperWorker(self.system)
        self.upload = S._UploadAhead((ds[i] for i in range(n)), ds.transform, device,
                                     runner=runner)
        self.frames = iter(self.upload)
        for _ in range(self.n_warm):
            self._frame()
        self.worker.q.join()
        sync(device)
        self.setup_split["warmup"] = time.perf_counter() - t0
        self.extra = {"oracle_bytes": self.oracle_bytes, "slam_hw": (ds.H_slam, ds.W_slam)}

    # -- one frame -----------------------------------------------------------
    def _frame(self):
        """Track the next frame and hand its work on.  Returns (t_ask,
        t_track0, t_track1, t_sync1, t_end, made_keyframe) or None when the
        stream has run out."""
        sy, tr = self.system, self.tracer
        t0 = time.perf_counter()
        try:
            img, info = next(self.frames)
        except StopIteration:
            return None
        n_kf = len(sy.keyframes)
        t1 = time.perf_counter()
        with tr.annotate("bench:track"):
            msg = sy.frontend.process_frame(img, info)
        t2 = t3 = t4 = time.perf_counter()
        if msg is not None:
            with tr.annotate("bench:backend_sync"):
                work = sy.backend.process_sync(msg)
            t3 = t4 = time.perf_counter()
            if work is not None:
                with tr.annotate("bench:submit"):
                    self.worker.submit(work)
                t4 = time.perf_counter()
        sy.n_frames += 1
        return t0, t1, t2, t3, t4, len(sy.keyframes) > n_kf

    def counters(self) -> dict:
        sy = self.system
        fe, bk = sy.frontend, sy.backend
        return {"trk_match": tuple(fe.tracker.timers.get("trk.match", (0.0, 0))),
                "gn_solve": tuple(bk.factor_graph.timers.get("gn.solve", (0.0, 0))),
                "train_steps": sy.scene_model.n_train_steps,
                "k3_rows": (fe.tracker.timers.get("trk.match", (0.0, 0))[1]
                            + bk.factor_graph.match_rows + bk.pair_matches),
                "frames": sy.n_frames, "keyframes": len(sy.keyframes),
                "lost": fe.lost_number}

    # -- the window ------------------------------------------------------------
    def run_window(self, seconds: float) -> Window:
        dev, tr, sy = self.device, self.tracer, self.system
        if dev.type == "cuda":
            self.extra["memory_setup_peak"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if tr.on:
            sy.frontend.tracker.sync_timing = True
            sy.backend.sync_timing = True
        lat, attempted, exhausted = [], 0, False
        first = sy.n_frames
        lost0 = sy.frontend.lost_number
        t_open = time.perf_counter()
        t_close = t_open + seconds
        tr.open(t_open, seconds, self.counters())
        while True:
            now = time.perf_counter()
            if now >= t_close:
                break
            tr.before_frame(now, self.counters, dev, self.worker.q.join)
            r = self._frame()
            if r is None:
                exhausted = True
                break
            attempted += 1
            t_ask, t1, t2, t3, t_end, made_kf = r
            if t_end <= t_close:
                lat.append(t_end - t_ask)
                tr.span("track", t2 - t1)
                tr.span("submit_wait", t_end - t3)
                if made_kf:
                    tr.span("backend_sync_kf", t3 - t2)
            tr.after_frame(self.counters, dev, self.worker.q.join)
        lost = sy.frontend.lost_number - lost0
        tr.close(self.counters(), self.counters, dev, self.worker.q.join)
        c0, c1 = tr.counters["open"], tr.counters["close"]
        log(f"window: {len(lat)} frames done, {attempted} handed, keyframes "
            f"{c1['keyframes'] - c0['keyframes']} (total {c1['keyframes']}), GN solves "
            f"{c1['gn_solve'][1] - c0['gn_solve'][1]}, train steps "
            f"{c1['train_steps'] - c0['train_steps']}, lost {lost}")
        self.window_ids = range(first, first + len(lat))
        return Window(seconds=seconds, latencies=lat, attempted=attempted,
                      failed=lost + int(exhausted), exhausted=exhausted)

    def finish(self) -> None:
        """Drain the worker and the device; keep what the check reads."""
        self.upload.close()
        self.worker.close()
        sync(self.device)
        if self.device.type == "cuda":
            win_peak = torch.cuda.max_memory_allocated(self.device)
            self.extra["memory_window_peak"] = win_peak
            self.extra["memory_peak_bytes"] = max(win_peak, self.extra["memory_setup_peak"])
        fe = self.system.frontend
        est = {}
        for rows in (fe.estimated_trajectory(), fe.keyframe_trajectory()):
            for row in rows:
                est[int(round(row[0]))] = np.asarray(row[1:8], np.float64)
        self.est = est
        self.kf_ids = [int(round(t)) for t in np.asarray(fe.keyframe_trajectory())[:, 0]]
        self.lost_in_window = self.tracer.counters["close"]["lost"] - \
            self.tracer.counters["open"]["lost"]

    def release(self) -> None:
        del self.system, self.worker, self.upload, self.frames
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The numbers judged: frames lost in the window; the worst relative
        pose error between consecutive frames of the window, and between
        consecutive keyframes of the window (from the last one before it)
        after the pose-graph GN.  ``control``: the generator's poses
        computed in bfloat16 stand in the program's place (its own numbers
        are logged as readings)."""
        if not control:
            return self._judge(self.est)
        prog = self._judge(self.est)
        log("program's numbers (readings of this control run): "
            + ", ".join(f"{k} {v!r}" for k, v in prog.items()))
        gt16 = stream.trajectory(self.mix, self.seed, len(self.gt), dtype="bfloat16")
        return self._judge({i: gt16[i] for i in self.est})

    def _judge(self, est: dict) -> dict:
        z = float(self.mix["plane_z"])
        ids = list(self.window_ids)
        # the window's keyframes and the last one before it
        before = [i for i in self.kf_ids if ids and i < ids[0]]
        kf = before[-1:] + [i for i in self.kf_ids if ids and ids[0] <= i <= ids[-1]]
        kf_in = sorted(i for i in kf if i in est)
        errs = [P.relative_error(est[a], est[b], self.gt[a], self.gt[b], z)
                for a, b in zip(kf_in[:-1], kf_in[1:])]
        if errs:
            worst = int(np.argmax(errs))
            log(f"keyframe relative errors (m): median {np.median(errs):.6f}, worst "
                f"{errs[worst]:.6f} between frames {kf_in[worst]} and {kf_in[worst + 1]}, "
                f"{len(errs)} pairs over frames {kf_in[0]}-{kf_in[-1]}")
        return {"lost_frames": float(self.lost_in_window),
                "frame_rpe_m": P.worst_consecutive_error(est, self.gt, ids, z),
                "keyframe_rpe_m": P.worst_consecutive_error(est, self.gt, kf, z)}
