"""Mapper keyframes: learnable pose (6D rotation + t) and 3x4 exposure with
per-keyframe Adam state, plus the image / inverse-depth pyramids.

Port of ``artdeco_tpu/mapper/keyframe.py``.  The learnable parameters live
in a capacity-allocated pool of tensors on the device, updated in place
row by row (the JAX package rebuilds the pool functionally).  Pyramids are
built on the device at ingest.
"""

from __future__ import annotations

import dataclasses

import torch

from artdeco_tpu_torch.ops import adam


def sixd_to_mtx(r: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 3, 2) -> (..., 3, 3) by Gram-Schmidt."""
    b1 = r[..., 0]
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = r[..., 1] - torch.sum(b1 * r[..., 1], dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def mtx_to_sixd(R: torch.Tensor) -> torch.Tensor:
    return R[..., :2]


@dataclasses.dataclass
class KeyframePool:
    """Capacity-allocated learnable keyframe parameters."""

    r_w2c: torch.Tensor              # (K, 3, 2) 6D rotation
    t_w2c: torch.Tensor              # (K, 3)
    exposure: torch.Tensor           # (K, 3, 4)
    lr_pose: torch.Tensor            # (K,)
    lr_exposure: torch.Tensor        # (K,)
    depth_loss_weight: torch.Tensor  # (K,)
    is_test: torch.Tensor            # (K,) bool
    used: torch.Tensor               # (K,) bool
    opt_r: adam.AdamState
    opt_t: adam.AdamState
    opt_e: adam.AdamState

    @property
    def capacity(self) -> int:
        return self.r_w2c.shape[0]


def create_pool(capacity: int, device) -> KeyframePool:
    r = torch.eye(3, device=device)[:, :2].repeat(capacity, 1, 1)
    zeros3 = torch.zeros(capacity, 3, device=device)
    expo = torch.eye(3, 4, device=device).repeat(capacity, 1, 1)
    zeros = lambda dt=torch.float32: torch.zeros(capacity, dtype=dt, device=device)
    return KeyframePool(
        r_w2c=r, t_w2c=zeros3, exposure=expo,
        lr_pose=zeros(), lr_exposure=zeros(), depth_loss_weight=zeros(),
        is_test=zeros(torch.bool), used=zeros(torch.bool),
        opt_r=adam.init_state(r), opt_t=adam.init_state(zeros3),
        opt_e=adam.init_state(expo),
    )


@torch.no_grad()
def register_keyframe(pool: KeyframePool, idx: int, Rt_w2c: torch.Tensor,
                      lr_pose: float, lr_exposure: float,
                      depth_loss_weight: float, is_test: bool) -> KeyframePool:
    """Register/overwrite keyframe ``idx`` in place (Rt 4x4 world->cam);
    the exposure is inherited from keyframe idx-1 (identity for 0)."""
    expo = (pool.exposure[idx - 1].clone() if idx > 0
            else torch.eye(3, 4, device=pool.exposure.device))
    return set_keyframe(pool, idx, Rt_w2c, expo, lr_pose, lr_exposure,
                        depth_loss_weight, is_test)


@torch.no_grad()
def set_keyframe(pool: KeyframePool, idx: int, Rt_w2c: torch.Tensor,
                 exposure: torch.Tensor, lr_pose: float, lr_exposure: float,
                 depth_loss_weight: float, is_test: bool) -> KeyframePool:
    """Register/overwrite keyframe ``idx`` in place with an explicit
    exposure (3, 4); its Adam moments restart from zero."""
    pool.r_w2c[idx] = Rt_w2c[:3, :2]
    pool.t_w2c[idx] = Rt_w2c[:3, 3]
    pool.exposure[idx] = exposure
    pool.lr_pose[idx] = lr_pose
    pool.lr_exposure[idx] = lr_exposure
    pool.depth_loss_weight[idx] = depth_loss_weight
    pool.is_test[idx] = is_test
    pool.used[idx] = True
    for st in (pool.opt_r, pool.opt_t, pool.opt_e):
        st.exp_avg[idx] = 0.0
        st.exp_avg_sq[idx] = 0.0
    return pool


def get_all_Rt(pool: KeyframePool) -> torch.Tensor:
    """(K, 4, 4) world->cam of every pool slot."""
    R = sixd_to_mtx(pool.r_w2c)
    top = torch.cat([R, pool.t_w2c[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=R.device).expand(R.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


def get_all_c2w(pool: KeyframePool) -> torch.Tensor:
    """(K, 4, 4) cam->world of every pool slot (the rigid inverse)."""
    Rt = get_all_Rt(pool)
    Rinv = Rt[:, :3, :3].transpose(-1, -2)
    tinv = -torch.einsum("kij,kj->ki", Rinv, Rt[:, :3, 3])
    top = torch.cat([Rinv, tinv[..., None]], dim=-1)
    return torch.cat([top, Rt[:, 3:]], dim=1)


def compose_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation + (3,) translation -> 4x4 (differentiable)."""
    top = torch.cat([R, t[:, None]], dim=-1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=R.device, dtype=R.dtype)
    return torch.cat([top, bottom], dim=0)


def get_Rt(pool: KeyframePool, idx: int) -> torch.Tensor:
    """4x4 world->cam of keyframe idx."""
    return compose_Rt(sixd_to_mtx(pool.r_w2c[idx]), pool.t_w2c[idx])


def cam_centres(pool: KeyframePool) -> torch.Tensor:
    """(K, 3) camera centres (-R^T t) of every pool slot."""
    R = sixd_to_mtx(pool.r_w2c)
    return -torch.einsum("kij,ki->kj", R, pool.t_w2c)


@dataclasses.dataclass
class KeyframeData:
    """Per-keyframe payloads as tensors: image and inverse-depth pyramids.

    Level 0 is map resolution; level l is avg-pooled by 2^l.  The tensors
    sit on the mapper's device while the keyframe is active and on the CPU
    once it is offloaded.
    """

    index: int
    global_frame_id: int
    image_name: str
    is_test: bool
    is_slam_keyframe: bool
    image_pyr: list            # [(3, H, W) f32] in [0, 1]
    idepth_pyr: list           # [(1, H, W) f32]
    conf_pyr: list             # [(1, H, W) f32]
    point_map: torch.Tensor    # (H_slam, W_slam, 3)
    point_conf: torch.Tensor   # (H_slam, W_slam)
    pyr_lvl: int = 0
    timestamp: float = 0.0


def resize_ac(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """align_corners=True bilinear resize of (c, H, W) (the keyframe
    pyramid's resize; unlike ``losses.resize_bilinear`` it really is
    align_corners=True and never antialiases)."""
    c, H, W = x.shape
    if (H, W) == (th, tw):
        return x
    ys = torch.linspace(0.0, H - 1.0, th, device=x.device)
    xs = torch.linspace(0.0, W - 1.0, tw, device=x.device)
    y0 = torch.clamp(torch.floor(ys).long(), 0, H - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, W - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    a = x[:, y0][:, :, x0]
    b = x[:, y0][:, :, x1]
    c_ = x[:, y1][:, :, x0]
    d = x[:, y1][:, :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c_ * wy * (1 - wx) + d * wy * wx)


def pool2(x: torch.Tensor) -> torch.Tensor:
    c, H, W = x.shape
    h2, w2 = H // 2, W // 2
    return x[:, : h2 * 2, : w2 * 2].reshape(c, h2, 2, w2, 2).mean(dim=(2, 4))


def build_pyramids(image: torch.Tensor, point_map: torch.Tensor,
                   point_conf: torch.Tensor, pyr_levels: int):
    """Image / inverse-depth / confidence pyramids at map resolution."""
    _, h, w = image.shape
    depth = point_map[..., 2][None]
    idepth = torch.where(depth != 0, 1.0 / (depth + 1e-4),
                         torch.full_like(depth, 1e4))
    image_pyr = [image.float()]
    idepth_pyr = [resize_ac(idepth, h, w)]
    conf_pyr = [resize_ac(point_conf[None], h, w)]
    for _ in range(pyr_levels - 1):
        image_pyr.append(pool2(image_pyr[-1]))
        idepth_pyr.append(pool2(idepth_pyr[-1]))
        conf_pyr.append(pool2(conf_pyr[-1]))
    return image_pyr, idepth_pyr, conf_pyr


def make_device_keyframe(
    index: int,
    global_frame_id: int,
    image,                    # (3, H, W) map-res in [0, 1], numpy or tensor
    point_map,                # (H_slam, W_slam, 3)
    point_conf,               # (H_slam, W_slam)
    is_test: bool,
    is_slam_keyframe: bool,
    device,
    pyr_levels: int = 2,
    image_name: str = "",
    timestamp: float = 0.0,
) -> KeyframeData:
    """Keyframe ingest: uploads the payloads and builds every pyramid on
    ``device``.  Training runs at ``pyr_lvl = pyr_levels - 1``."""
    image, point_map, point_conf = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (image, point_map, point_conf))
    image_pyr, idepth_pyr, conf_pyr = build_pyramids(
        image, point_map, point_conf, pyr_levels)
    return KeyframeData(
        index=index,
        global_frame_id=global_frame_id,
        image_name=image_name or f"frame_{global_frame_id:06d}",
        is_test=is_test,
        is_slam_keyframe=is_slam_keyframe,
        image_pyr=image_pyr,
        idepth_pyr=idepth_pyr,
        conf_pyr=conf_pyr,
        point_map=point_map,
        point_conf=point_conf,
        pyr_lvl=pyr_levels - 1,
        timestamp=timestamp,
    )
