"""Headless Gaussian scene viewer: orbit and turntable renders, exported
as PNG frames and an MP4.

Port of ``artdeco_tpu/runtime/gaussianviewer.py``.  Every frame is one
``render_core`` (K1 on the card) under ``torch.no_grad()``; the modes are
splat, depth (inverse depth normalised between its 5th and 95th
percentiles) and alpha.  ``export_turntable`` writes ``{mode}_{i:04d}.png``
through ``scene_io.write_png`` and ``turntable_{mode}.mp4`` through
``dataio.video.write_mp4`` (JPEG frames: the JAX package's ``mp4v`` needs a
codec library).  Where the JAX package falls back to ``.npy`` files on any
exception, a failure here raises.

``timers`` sums seconds per stage ("render", "copy", "png", "jpeg"); with
``sync_timing`` the device is synchronised after each render, so "render"
holds its device-synchronised time and "copy" the copy to the host alone.
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

MODES = ("splat", "depth", "alpha")


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0, -1, 0)) -> np.ndarray:
    """world->cam 4x4 from eye/target (OpenCV convention, +z forward)."""
    f = target - eye
    f = f / np.linalg.norm(f)
    u = np.asarray(up, np.float64)
    r = np.cross(f, u)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f])
    Rt = np.eye(4, dtype=np.float32)
    Rt[:3, :3] = R
    Rt[:3, 3] = -R @ eye
    return Rt


class StageTimers:
    """Seconds and counts per stage; ``sync_timing`` synchronises the
    device at each stage boundary (see the module docstring)."""

    def __init__(self):
        self.timers: dict = {}
        self.sync_timing = False

    def _tick(self, key: str, t0: float, device: torch.device) -> float:
        if self.sync_timing and device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        acc = self.timers.setdefault(key, [0.0, 0])
        acc[0] += now - t0
        acc[1] += 1
        return now


def render_view(sm, Rt_w2c: torch.Tensor, width: int, height: int, slab=None,
                gfeat=None, mlp=None) -> dict:
    """``render_core`` of ``sm``'s scene (or of the ``slab``, ``gfeat`` and
    ``mlp`` given) from the world->cam ``Rt_w2c`` at width x height, the
    focal scaled from ``sm``'s height and the principal point centred."""
    from artdeco_tpu_torch.mapper.scene_model import render_core

    slab = sm.slab if slab is None else slab
    dev = slab.xyz.device
    f = sm.f * height / sm.height
    K = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]],
                     dtype=torch.float32, device=dev)
    with torch.no_grad():
        return render_core(slab, sm.gfeat.val if gfeat is None else gfeat,
                           sm.mlp if mlp is None else mlp,
                           torch.as_tensor(Rt_w2c, dtype=torch.float32, device=dev),
                           torch.eye(3, 4, device=dev), K, width, height,
                           torch.zeros(3, device=dev), sm.cfg.sh_degree,
                           sm.cfg.low_pass_filter_eps, sm.cfg.cluster_capacity)


class GaussianViewer(StageTimers):
    """Headless viewer over a scene (a ``SceneModel`` or
    ``scene_io.load_scene_for_viewing``'s): splat / depth / alpha modes."""

    MODES = MODES

    def __init__(self, scene_model, width: int = 480, height: int = 270):
        super().__init__()
        self.sm = scene_model
        self.width = width
        self.height = height
        self.renders = 0

    def render_pose(self, Rt_w2c: np.ndarray, mode: str = "splat") -> np.ndarray:
        """(height, width, 3) uint8 frame of the view ``Rt_w2c``."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode}")
        dev = self.sm.slab.xyz.device
        t0 = time.perf_counter()
        pkg = render_view(self.sm, np.asarray(Rt_w2c), self.width, self.height)
        self.renders += 1
        t0 = self._tick("render", t0, dev)
        if mode == "splat":
            img = torch.clamp(pkg["render"], 0, 1).cpu().numpy()
        elif mode == "depth":
            inv = pkg["invdepth"][0].cpu().numpy()
        else:
            img = np.repeat(pkg["alpha"].cpu().numpy(), 3, 0)
        self._tick("copy", t0, dev)
        if mode == "depth":
            lo, hi = np.percentile(inv, 5), np.percentile(inv, 95)
            img = np.repeat(np.clip((inv - lo) / max(hi - lo, 1e-9), 0, 1)[None], 3, 0)
        return (img.transpose(1, 2, 0) * 255).astype(np.uint8)

    def scene_centre_radius(self):
        slab = self.sm.slab
        sel = np.where(slab.active.cpu().numpy())[0]
        if sel.size == 0:
            return np.zeros(3), 1.0
        xyz = slab.xyz.cpu().numpy()[sel]
        c = np.median(xyz, axis=0)
        r = float(np.percentile(np.linalg.norm(xyz - c, axis=1), 90))
        return c, max(r, 1e-3)

    def turntable(self, n_frames: int = 60, mode: str = "splat", elevation: float = 0.3,
                  radius_scale: float = 1.5) -> List[np.ndarray]:
        centre, radius = self.scene_centre_radius()
        frames = []
        for i in range(n_frames):
            a = 2 * np.pi * i / n_frames
            eye = centre + radius_scale * radius * np.asarray(
                [np.sin(a), -elevation, -np.cos(a)])
            frames.append(self.render_pose(_look_at(eye, centre), mode))
        return frames

    def export_turntable(self, out_dir: str, n_frames: int = 60, mode: str = "splat") -> str:
        """The turntable as ``{mode}_{i:04d}.png`` frames and
        ``turntable_{mode}.mp4`` (30 fps) in ``out_dir``; returns the MP4's
        path."""
        from artdeco_tpu_torch.dataio.jpeg import encode_jpeg
        from artdeco_tpu_torch.dataio.video import write_mp4
        from artdeco_tpu_torch.mapper.scene_io import write_png

        os.makedirs(out_dir, exist_ok=True)
        frames = self.turntable(n_frames, mode)
        host = torch.device("cpu")
        samples = []
        for i, fr in enumerate(frames):
            t0 = time.perf_counter()
            write_png(os.path.join(out_dir, f"{mode}_{i:04d}.png"), fr)
            t0 = self._tick("png", t0, host)
            samples.append(encode_jpeg(fr))
            self._tick("jpeg", t0, host)
        vid = os.path.join(out_dir, f"turntable_{mode}.mp4")
        write_mp4(vid, samples, self.width, self.height, fps=30)
        return vid
