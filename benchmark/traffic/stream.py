"""The one traffic generator: a seeded camera stream over a textured plane.

A mix file (``traffic/<mix>.json``) gives the parameters; ``--seed`` draws
what varies between runs without changing the amount of work: the
direction along the mix's heading, the sign of the camera's roll, and
the texture's orientations and phases.  Step length, roll amplitude, texture
periods, sizes and frame counts are the mix's, identical for every seed.

Geometry (the oracle's scene): the plane z_w = ``plane_z`` seen by a
pinhole camera with focal 0.8 * width and the principal point at the
image centre, moving in the plane z_w = 0 and rolling about its optical
axis.  Pixel (u, v) sees the world point t + plane_z * R [(u - cx) / f,
(v - cy) / f, 1], whose texture colour it takes, so the images agree with
the exact geometry the oracle serves.

Frames are drawn on the device in batches and returned as uint8 on the
host (``host=True``) or on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FOCAL_FRAC = 0.8      # focal length / image width, as the program's synthetic stream


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, salt])


def trajectory(mix: dict, seed: int, n: int, dtype=np.float64) -> np.ndarray:
    """(n, 7) camera-to-world poses [t, q_xyzw]: frame 0 ``start_m`` (0
    where the mix gives none) from the origin with identity rotation, a
    straight path away from it of ``step_m`` a frame along
    ``heading_rad`` or its opposite (the seed picks), and a roll of
    +-``roll_amp_rad`` * sin(2 pi i / ``roll_period_frames``) (the seed
    picks the sign).  Both choices mirror the stream, so every seed asks
    the same work.  ``dtype`` is the arithmetic's type (float64; the oracle
    cells' control computes it in bfloat16)."""
    r = _rng(seed, 1)
    heading = float(mix["heading_rad"]) + (math.pi if r.uniform() < 0.5 else 0.0)
    sign = 1.0 if r.uniform() < 0.5 else -1.0
    i = np.arange(n, dtype=np.float64)
    step = float(mix["step_m"])
    dist = float(mix.get("start_m", 0.0)) + step * i
    roll = sign * float(mix["roll_amp_rad"]) * np.sin(2.0 * math.pi * i /
                                                       float(mix["roll_period_frames"]))
    poses = np.zeros((n, 7), np.float64)
    poses[:, 0] = dist * math.cos(heading)
    poses[:, 1] = dist * math.sin(heading)
    poses[:, 5] = np.sin(0.5 * roll)
    poses[:, 6] = np.cos(0.5 * roll)
    if dtype == "bfloat16":
        poses = torch.as_tensor(poses).to(torch.bfloat16).double().numpy()
        poses[:, 3:7] /= np.linalg.norm(poses[:, 3:7], axis=1, keepdims=True)
    return poses


def texture_params(mix: dict, seed: int) -> dict:
    """Per channel and per period of ``texture_periods_m``: an orientation
    and a phase drawn from the seed."""
    r = _rng(seed, 2)
    k = len(mix["texture_periods_m"])
    return {"angle": r.uniform(0.0, math.pi, (3, k)),
            "phase": r.uniform(0.0, 2.0 * math.pi, (3, k))}


def frames(mix: dict, seed: int, poses: np.ndarray, device, host: bool = True,
           batch: int = 16):
    """(n, H, W, 3) uint8 frames of the mix at ``poses``, drawn on
    ``device`` ``batch`` frames at a time; numpy on the host, or a device
    tensor when ``host`` is False."""
    W, H = int(mix["width"]), int(mix["height"])
    f = FOCAL_FRAC * W
    z = float(mix["plane_z"])
    tex = texture_params(mix, seed)
    periods = torch.as_tensor(mix["texture_periods_m"], dtype=torch.float32, device=device)
    amp = float(mix["texture_contrast"]) / len(mix["texture_periods_m"])
    ang = torch.as_tensor(tex["angle"], dtype=torch.float32, device=device)
    ph = torch.as_tensor(tex["phase"], dtype=torch.float32, device=device)
    kx = (2.0 * math.pi * torch.cos(ang) / periods)        # (3, k)
    ky = (2.0 * math.pi * torch.sin(ang) / periods)
    a = ((torch.arange(W, device=device, dtype=torch.float32) - W / 2) / f)[None, None, :]
    b = ((torch.arange(H, device=device, dtype=torch.float32) - H / 2) / f)[None, :, None]
    n = len(poses)
    out = (np.empty((n, H, W, 3), np.uint8) if host
           else torch.empty((n, H, W, 3), dtype=torch.uint8, device=device))
    P = torch.as_tensor(poses, dtype=torch.float32, device=device)
    for s in range(0, n, batch):
        p = P[s:s + batch]
        roll = 2.0 * torch.atan2(p[:, 5], p[:, 6])
        c, sn = torch.cos(roll)[:, None, None], torch.sin(roll)[:, None, None]
        Xw = p[:, 0, None, None] + z * (c * a - sn * b)                 # (B, H, W)
        Yw = p[:, 1, None, None] + z * (sn * a + c * b)
        arg = (Xw[..., None, None] * kx + Yw[..., None, None] * ky + ph)  # (B, H, W, 3, k)
        img = (0.5 + amp * torch.sin(arg).sum(-1)).clamp(0.0, 1.0)
        img = (img * 255.0 + 0.5).to(torch.uint8)
        if host:
            out[s:s + len(p)] = img.cpu().numpy()
        else:
            out[s:s + len(p)] = img
    return out
