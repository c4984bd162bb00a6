"""LOD Gaussian scene model: the online mapper.

Port of ``artdeco_tpu/mapper/scene_model.py``: dmax-based LOD selection
with alpha fade, per-voxel global features with the ``mlp_cov`` scale and
rotation modulation MLP, randomized-keyframe replay training, LoG
multi-resolution densification over LODs (1, 2, 4, 8), voxel-hash cluster
ids, visibility weeding and PSNR/SSIM evaluation.

PyTorch form: the state is dataclasses of tensors on one ``device``; a
training iteration computes the loss with autograd (the compositor's
backward is kernel K2) and applies the Adam updates under ``no_grad``; a
burst is a Python loop over iterations.  Host randomness (keyframe and
background sampling) is ``np.random.RandomState(seed)`` consumed exactly as
the JAX package consumes it; densification draws its uniforms from a noise
source it is given (a ``torch.Generator`` on the device by default).

With a mesh (``enable_mesh``, ``parallel/``), each training iteration
trains one keyframe per slot through the data-parallel step
(``parallel/dp.py``) and full-frame renders are sharded by row strips
(``parallel/splats.py``); densify, weed and save stay on the model's
device.  Left out, being TPU-only machinery: AOT prewarm and growth hooks,
the visible-set compaction budget and the jit wrappers.
The training bucket ``_train_len`` stays: the slab length it selects
enters the loss through the mean scaling regulariser.  Loop closure moves
the keyframe poses (``set_keyframe_poses_masked``) and the Gaussians with
them (``rigid_transform_gs``); ``save`` writes the scene
(``mapper/scene_io.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper import clustering, gaussians as G, keyframe as KF, losses
from artdeco_tpu_torch.ops import adam
from artdeco_tpu_torch.ops.splat import api as splat_api
from artdeco_tpu_torch.ops.splat import sh as sh_lib
from artdeco_tpu_torch.ops.ssim import fused_ssim

LODS = (1, 2, 4, 8)
MLP_KEYS = ("w1", "b1", "w2", "b2")


# ---------------------------------------------------------------------------
# mlp_cov: 2-layer MLP modulating scale/rotation from cluster+local features
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MlpCov:
    w1: torch.Tensor  # (D, D)
    b1: torch.Tensor  # (D,)
    w2: torch.Tensor  # (D, 7)
    b2: torch.Tensor  # (7,)


def create_mlp_cov(feat_dim: int, generator: torch.Generator, device) -> MlpCov:
    """nn.Linear's init: weights and biases ~ U(-1/sqrt(fan_in), +).  The
    nonzero biases matter: zero-feature (inactive) rows must not give an
    exactly-zero rotation modulation (NaN on normalize)."""
    s1 = 1.0 / math.sqrt(feat_dim)

    def u(*shape):
        return ((torch.rand(*shape, generator=generator) * 2.0 - 1.0) * s1).to(device)

    return MlpCov(w1=u(feat_dim, feat_dim), b1=u(feat_dim), w2=u(feat_dim, 7),
                  b2=u(7))


def mlp_cov_apply(m: MlpCov, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ m.w1 + m.b1)
    return h @ m.w2 + m.b2


@dataclasses.dataclass
class GlobalFeats:
    val: torch.Tensor  # (Cg, Dg)
    lr: torch.Tensor   # (Cg,)
    opt: adam.AdamState


def create_global_feats(capacity: int, dim: int, lr_init: float, device) -> GlobalFeats:
    v = torch.zeros(capacity, dim, device=device)
    return GlobalFeats(val=v, lr=torch.full((capacity,), lr_init, device=device),
                       opt=adam.init_state(v))


# ---------------------------------------------------------------------------
# Render core
# ---------------------------------------------------------------------------

def effective_params(slab: G.GaussianSlab, gfeat: torch.Tensor, mlp: MlpCov,
                     viewmat: torch.Tensor, cluster_capacity: int):
    """dmax LOD culling/fade + mlp_cov modulation: the view-dependent
    effective splat parameters."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    cam_centre = -R.T @ t
    delta = slab.xyz - cam_centre
    # sqrt has an infinite derivative at 0: eps inside the sqrt
    ob_dist = torch.sqrt(torch.sum(delta * delta, dim=-1, keepdim=True) + 1e-12)
    selection = (ob_dist < 2.0 * slab.d_max)[:, 0] & slab.active
    fade = (ob_dist > slab.d_max) & (ob_dist < 2.0 * slab.d_max)
    alpha_ratio = torch.where(fade, (2.0 * slab.d_max - ob_dist) / slab.d_max,
                              torch.ones_like(ob_dist))
    opac = (torch.sigmoid(slab.opacity) * alpha_ratio)[:, 0]

    cls = torch.clamp(slab.cls_id.long(), 0, cluster_capacity - 1)
    feats_in = torch.cat([gfeat[cls], slab.local_feat], dim=-1)
    scale_rot = mlp_cov_apply(mlp, feats_in)
    scale_eff = torch.exp(slab.scaling) * torch.sigmoid(scale_rot[:, :3])
    rot_mod = slab.rotation * scale_rot[:, 3:7]
    rot_eff = rot_mod * torch.rsqrt(
        torch.sum(rot_mod * rot_mod, dim=-1, keepdim=True) + 1e-20)
    colors = torch.cat([slab.f_dc, slab.f_rest], dim=1)  # (C, K, 3)
    return selection, opac, scale_eff, rot_eff, colors


def render_core(slab: G.GaussianSlab, gfeat: torch.Tensor, mlp: MlpCov,
                viewmat: torch.Tensor, exposure: torch.Tensor, K: torch.Tensor,
                width: int, height: int, bg: torch.Tensor, sh_degree: int,
                eps2d: float, cluster_capacity: int) -> dict:
    """Render + exposure.  Returns render (3, H, W) clamped, invdepth,
    depth, alpha (1, H, W), visibility (C,), global_visibility (Cg,) and
    scale (C, 3)."""
    selection, opac, scale_eff, rot_eff, colors = effective_params(
        slab, gfeat, mlp, viewmat, cluster_capacity)
    render, alpha, meta = splat_api.rasterization(
        slab.xyz, rot_eff, scale_eff, opac, colors, viewmat, K, width, height,
        sh_degree=sh_degree, render_mode="RGB+D", eps2d=eps2d,
        valid_mask=selection,
    )
    visibility = (torch.amax(meta.radii, dim=-1) > 0) & selection
    out = finish_render(render, alpha, visibility, slab.cls_id, exposure, bg,
                        cluster_capacity)
    out["scale"] = scale_eff
    return out


def finish_render(render: torch.Tensor, alpha: torch.Tensor, visibility: torch.Tensor,
                  cls_id: torch.Tensor, exposure: torch.Tensor, bg: torch.Tensor,
                  cluster_capacity: int) -> dict:
    """The rasterizer's (H, W, 4) RGB+D render and (H, W, 1) alpha with
    per-Gaussian ``visibility`` -> render_core's dict: the background, the
    exposure affine, the clamp, the inverse depth and the per-cluster
    visibility."""
    rgb = render[..., :3].permute(2, 0, 1)
    depth = render[..., 3:4].permute(2, 0, 1)
    a = alpha.permute(2, 0, 1)
    rgb = rgb + (1.0 - a) * bg[:, None, None]
    # the reference divides by the raw accumulated depth, which is 0 at
    # uncovered pixels (inf loss); the clamp at 1e-2 zeroes the gradient
    # there instead
    invdepth = 1.0 / torch.clamp_min(depth, 1e-2)

    h, w = rgb.shape[1:]
    rgb = (exposure[:3, :3] @ rgb.reshape(3, -1) + exposure[:3, 3:4]).reshape(3, h, w)
    rgb = torch.clamp(rgb, 0.0, 1.0)

    cls = torch.clamp(cls_id.long(), 0, cluster_capacity - 1)
    global_vis = torch.zeros(cluster_capacity, dtype=torch.int32,
                             device=cls.device).scatter_reduce(
        0, cls, visibility.to(torch.int32), "amax") > 0
    return dict(render=rgb, invdepth=invdepth, alpha=a, visibility=visibility,
                global_visibility=global_vis, depth=depth)


# ---------------------------------------------------------------------------
# One training iteration
# ---------------------------------------------------------------------------

GRAD_NAMES = (*G.TRAINED_KEYS, "gfeat", *("mlp." + k for k in MLP_KEYS), "r", "t", "e")


def loss_and_grads(slab: G.GaussianSlab, gfeat_val: torch.Tensor, mlp: MlpCov,
                   r0: torch.Tensor, t0: torch.Tensor, e0: torch.Tensor,
                   dlw: torch.Tensor, gt: torch.Tensor, mono: torch.Tensor,
                   K_lvl: torch.Tensor, bg: torch.Tensor, width: int, height: int,
                   is_important: bool, cfg: MapperConfig):
    """One view's training loss and its gradients.

    r0, t0, e0 are the keyframe's pose and exposure rows, ``dlw`` its
    depth-loss weight, gt (3, h, w) and mono (1, h, w) its image and mono
    inverse depth at the training level.  Returns (loss, grads by
    ``GRAD_NAMES``, visibility (C,), global visibility (Cg,), the loss
    terms (l1, ssim, depth))."""
    leaves = {k: getattr(slab, k).detach().requires_grad_() for k in G.TRAINED_KEYS}
    g_val = gfeat_val.detach().requires_grad_()
    mlp_t = MlpCov(**{k: getattr(mlp, k).detach().requires_grad_() for k in MLP_KEYS})
    r0, t0, e0 = (x.detach().clone().requires_grad_() for x in (r0, t0, e0))

    viewmat = KF.compose_Rt(KF.sixd_to_mtx(r0), t0)
    pkg = render_core(
        dataclasses.replace(slab, **leaves), g_val, mlp_t, viewmat, e0, K_lvl,
        width, height, bg, cfg.sh_degree, cfg.low_pass_filter_eps,
        cfg.cluster_capacity,
    )
    image, invdepth = pkg["render"], pkg["invdepth"]
    rdk = losses.radial_decay_kernel(height, width, cfg.rad_decay,
                                      device=image.device)[None]
    if not is_important:
        # common frames: mask pixels with large errors
        err = rdk * torch.abs(image - gt)
        bad = (err[0] > 0.2) | (err[1] > 0.2) | (err[2] > 0.2)
        m = (~bad)[None].to(image.dtype)
        image, gt, invdepth, mono = image * m, gt * m, invdepth * m, mono * m
    l1 = torch.mean(rdk * torch.abs(image - gt))
    ssim_l = 1.0 - fused_ssim(image, gt)
    depth_l = torch.mean(rdk * torch.abs(invdepth - mono))
    scaling_reg = torch.mean(torch.prod(pkg["scale"], dim=1))
    loss = (cfg.lambda_dssim * ssim_l + (1.0 - cfg.lambda_dssim) * l1
            + dlw * depth_l + cfg.scaling_reg_factor * scaling_reg)

    inputs = [*leaves.values(), g_val, *(getattr(mlp_t, k) for k in MLP_KEYS),
              r0, t0, e0]
    g = torch.autograd.grad(loss, inputs, allow_unused=True, materialize_grads=True)
    return (loss.detach(), dict(zip(GRAD_NAMES, g)), pkg["visibility"],
            pkg["global_visibility"], (l1.detach(), ssim_l.detach(), depth_l.detach()))


@torch.no_grad()
def keyframe_row_steps(pool: KF.KeyframePool, kf_idx: int, grads: dict,
                       is_test: bool) -> dict:
    """The keyframe's pose and exposure Adam steps (betas 0.8/0.99; a test
    frame's exposure lr is 0): {"r" | "t" | "e": (new row, AdamState)}.
    Reads the pool and writes nothing."""
    lr_pose = pool.lr_pose[kf_idx]
    lr_expo = 0.0 if is_test else pool.lr_exposure[kf_idx]
    out = {}
    for name, param, st, lr in (("r", pool.r_w2c, pool.opt_r, lr_pose),
                                ("t", pool.t_w2c, pool.opt_t, lr_pose),
                                ("e", pool.exposure, pool.opt_e, lr_expo)):
        out[name] = adam.adam_update_basic(
            param[kf_idx], grads[name],
            adam.AdamState(st.exp_avg[kf_idx], st.exp_avg_sq[kf_idx]),
            lr, b1=0.8, b2=0.99,
        )
    return out


@torch.no_grad()
def scene_update(slab: G.GaussianSlab, opt: G.SlabOptState, gfeat: GlobalFeats,
                 mlp: MlpCov, mlp_opt: dict, mlp_lr: torch.Tensor, grads: dict,
                 vis: torch.Tensor, gvis: torch.Tensor, cfg: MapperConfig):
    """The scene's Adam step from ``grads``: visibility-masked slab Adam with
    the xyz lr decay, cluster-masked global features (per-row lr, no decay),
    dense ``mlp_cov`` Adam and its lr decay.  Returns the new (slab, opt,
    gfeat, mlp, mlp_opt, mlp_lr)."""
    lrs = dict(f_dc=cfg.feature_lr, f_rest=cfg.feature_lr / 20.0,
               scaling=cfg.scaling_lr, rotation=cfg.rotation_lr,
               opacity=cfg.opacity_lr, local_feat=cfg.feat_lr)
    slab, opt = G.apply_adam(
        slab, opt, {k: grads[k] for k in G.TRAINED_KEYS}, vis, lrs,
        cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
    )
    slab = G.decay_xyz_lr(slab, vis, cfg.position_lr_decay,
                          cfg.position_lr_init * 0.1)
    gv, g_opt = adam.adam_update_masked(
        gfeat.val, grads["gfeat"], gfeat.opt, gfeat.lr, gvis,
        b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
    )
    gfeat = GlobalFeats(val=gv, lr=gfeat.lr, opt=g_opt)
    new_mlp, new_mlp_opt = {}, {}
    for k in MLP_KEYS:
        new_mlp[k], new_mlp_opt[k] = adam.adam_update_basic(
            getattr(mlp, k), grads["mlp." + k], mlp_opt[k], mlp_lr,
            b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
        )
    mlp_lr = torch.clamp_min(mlp_lr * cfg.mlp_cov_lr_decay, cfg.mlp_cov_lr_init * 0.1)
    return slab, opt, gfeat, MlpCov(**new_mlp), new_mlp_opt, mlp_lr


def _train_iter(
    slab: G.GaussianSlab,
    opt: G.SlabOptState,
    gfeat: GlobalFeats,
    mlp: MlpCov,
    mlp_opt: dict,
    mlp_lr: torch.Tensor,
    pool: KF.KeyframePool,
    kf_idx: int,
    gt_image: torch.Tensor,     # (3, h, w) at lvl
    mono_idepth: torch.Tensor,  # (1, h, w) at lvl
    K_lvl: torch.Tensor,
    bg: torch.Tensor,
    is_test: bool,
    width: int,
    height: int,
    is_important: bool,
    cfg: MapperConfig,
):
    """One mapper training iteration.

    Returns (slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool, metrics, grads).
    The keyframe's pool row (pose, exposure, their Adam moments, depth
    loss weight) is updated in place; everything else is returned new.
    Test frames train only their pose: the scene, mlp and global-feature
    updates are skipped, which is what the JAX package's all-False masks
    compute.  ``grads`` holds the loss gradients by name.
    """
    loss, grads, vis, gvis, (l1, ssim_l, depth_l) = loss_and_grads(
        slab, gfeat.val, mlp, pool.r_w2c[kf_idx], pool.t_w2c[kf_idx],
        pool.exposure[kf_idx], pool.depth_loss_weight[kf_idx], gt_image, mono_idepth,
        K_lvl, bg, width, height, is_important, cfg)

    with torch.no_grad():
        for (param, st), (p, s) in zip(
                ((pool.r_w2c, pool.opt_r), (pool.t_w2c, pool.opt_t),
                 (pool.exposure, pool.opt_e)),
                keyframe_row_steps(pool, kf_idx, grads, is_test).values()):
            param[kf_idx] = p
            st.exp_avg[kf_idx] = s.exp_avg
            st.exp_avg_sq[kf_idx] = s.exp_avg_sq
        pool.depth_loss_weight[kf_idx] *= cfg.depth_loss_weight_decay
        if not is_test:
            slab, opt, gfeat, mlp, mlp_opt, mlp_lr = scene_update(
                slab, opt, gfeat, mlp, mlp_opt, mlp_lr, grads, vis, gvis, cfg)

    metrics = dict(loss=loss, l1=l1, ssim=ssim_l, depth=depth_l, n_vis=torch.sum(vis))
    return slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool, metrics, grads


# ---------------------------------------------------------------------------
# Densification, pruning, weeding
# ---------------------------------------------------------------------------

Uniforms = Callable[[tuple], torch.Tensor]


class DeviceUniforms:
    """Densification noise: U[0, 1) float32 from a ``torch.Generator`` on
    the device."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, shape: tuple) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)


def _densify_candidates(
    image: torch.Tensor,         # (3, H, W) map-res image
    render_rgb: Optional[torch.Tensor],  # (3, H, W) current render, None if empty
    point_map_z: torch.Tensor,   # (1, Hs, Ws) SLAM depth
    point_conf: torch.Tensor,    # (1, Hs, Ws)
    R_w2c: torch.Tensor,
    t_w2c: torch.Tensor,
    f: float,
    u: torch.Tensor,             # (cur_h, cur_w) uniforms
    pri_u: torch.Tensor,         # (cur_h * cur_w,) uniforms
    lod: int,
    width: int,
    height: int,
    budget: int,
    cfg: MapperConfig,
) -> dict:
    """Candidate Gaussians for one LOD: saliency-sampled pixels lifted
    through the SLAM depth; a fixed budget of them, sampled pixels first."""
    cur_h, cur_w = height // lod, width // lod
    dev = image.device
    img = losses.resize_bilinear(losses.avg_pool2(image), cur_h, cur_w)
    disc = losses.disc_kernel(3, device=dev)
    init_proba = losses.lapla_norm(img, disc) * cfg.init_proba_scaler
    if render_rgb is not None:
        render_l = losses.resize_bilinear(render_rgb, cur_h, cur_w)
        penalty = losses.lapla_norm(render_l, disc) * cfg.init_proba_scaler
    else:
        penalty = torch.zeros_like(init_proba)

    sample_mask = u < (init_proba - penalty) * cfg.gs_add_ratio
    pri = pri_u + sample_mask.reshape(-1)
    # top-k by a stable descending sort: equal priorities keep index order,
    # as jax.lax.top_k does (torch.topk leaves tie order unspecified)
    top_idx = torch.sort(pri, descending=True, stable=True).indices[:budget]
    chosen = sample_mask.reshape(-1)[top_idx]
    uu = (top_idx % cur_w).float()
    vv = (top_idx // cur_w).float()

    hs, ws = point_map_z.shape[1:]
    uv_s = torch.stack([uu * (ws - 1) / max(cur_w - 1, 1),
                        vv * (hs - 1) / max(cur_h - 1, 1)], dim=-1)
    depths = losses.grid_sample_bilinear(point_map_z, uv_s)[0]
    confs = losses.grid_sample_bilinear(point_conf, uv_s)[0]

    qmin = torch.clamp_max(torch.quantile(point_map_z.reshape(-1), 0.02), 1e-2)
    valid = chosen & (confs >= 0) & (depths > qmin)

    # back-project: world = R^T (p_cam - t) == (p_cam - t) @ R
    f_l = f / lod
    cx, cy = (width - 1) / 2.0 / lod, (height - 1) / 2.0 / lod
    x = (uu - cx) / f_l * depths
    y = (vv - cy) / f_l * depths
    pts_w = (torch.stack([x, y, depths], dim=-1) - t_w2c) @ R_w2c

    rgb = img.reshape(3, -1)[:, top_idx].T
    f_dc = sh_lib.rgb_to_sh(rgb)[:, None, :]

    # scales from saliency
    p_sel = init_proba.reshape(-1)[top_idx]
    scales = 1.0 / torch.sqrt(torch.clamp_min(p_sel, 1e-12))
    scales = torch.clamp(scales, 1.0, width / 10.0) / f
    centre_w = -t_w2c @ R_w2c
    dist = torch.linalg.norm(pts_w - centre_w, dim=-1)
    scales = scales * dist
    scaling = torch.log(torch.clamp(lod * scales, 1e-6, 1e6))[:, None].repeat(1, 3)

    opac = torch.clamp(0.2 * confs, 1e-4, 1.0 - 1e-4)
    opacity = torch.log(opac / (1.0 - opac))[:, None]
    return dict(xyz=pts_w, f_dc=f_dc, scaling=scaling, opacity=opacity,
                d_max=(depths * lod)[:, None], valid=valid)


@torch.no_grad()
def densify_all_lods_core(image, render_rgb, point_map_z, point_conf,
                          pool: KF.KeyframePool, kf_idx: int, f: float,
                          uniforms: Uniforms, width: int, height: int,
                          budget: int, cfg: MapperConfig, sh_k: int,
                          local_feat_dim: int):
    """The multi-LOD densification candidate pass.  Draws, per LOD in
    order, a (cur_h, cur_w) and a (cur_h * cur_w,) block of uniforms.

    Returns (fields dict of every slab column except cls_id, valid (B,),
    centre_w (3,))."""
    viewmat = KF.get_Rt(pool, kf_idx)
    R_w2c, t_w2c = viewmat[:3, :3], viewmat[:3, 3]
    per = []
    for lod in LODS:
        cur_h, cur_w = height // lod, width // lod
        u = uniforms((cur_h, cur_w))
        pri_u = uniforms((cur_h * cur_w,))
        b_lod = min(budget, cur_h * cur_w)
        per.append(_densify_candidates(
            image, render_rgb, point_map_z, point_conf, R_w2c, t_w2c, f, u,
            pri_u, lod, width, height, b_lod, cfg))

    def cat(key):
        return torch.cat([c[key] for c in per], dim=0)

    xyz = cat("xyz")
    b, dev = xyz.shape[0], xyz.device
    fields = dict(
        xyz=xyz,
        f_dc=cat("f_dc"),
        f_rest=torch.zeros(b, sh_k - 1, 3, device=dev),
        scaling=cat("scaling"),
        rotation=torch.tensor([1.0, 0, 0, 0], device=dev).repeat(b, 1),
        opacity=cat("opacity"),
        local_feat=torch.zeros(b, local_feat_dim, device=dev),
        d_max=cat("d_max"),
        kf_id=torch.full((b,), kf_idx, dtype=torch.int32, device=dev),
        xyz_lr=torch.full((b,), cfg.position_lr_init, device=dev),
    )
    return fields, cat("valid"), -t_w2c @ R_w2c


@torch.no_grad()
def densify_prune_keep(slab: G.GaussianSlab, centre_w: torch.Tensor, f: float,
                       width: int) -> torch.Tensor:
    """Opacity / screen-size keep mask applied before insert."""
    opac = torch.sigmoid(slab.opacity[:, 0])
    dist = torch.linalg.norm(slab.xyz - centre_w, dim=-1)
    screen = f * torch.amax(torch.exp(slab.scaling), -1) / torch.clamp_min(dist, 1e-9)
    return (opac > 0.05) & (screen < 0.5 * width)


@torch.no_grad()
def weed_keep(slab: G.GaussianSlab, centres: torch.Tensor, used: torch.Tensor,
              visible_threshold: float, chunk: int = 64) -> torch.Tensor:
    """Visibility-fraction keep mask: a Gaussian stays when more than
    ``visible_threshold`` of the used keyframes lie within 2 d_max."""
    n_kf = max(int(used.sum()), 1)
    c_used = centres[used]
    count = torch.zeros(slab.capacity, dtype=torch.int64, device=slab.xyz.device)
    for i in range(0, c_used.shape[0], chunk):
        d = torch.linalg.norm(slab.xyz[:, None, :] - c_used[None, i:i + chunk],
                              dim=-1)
        count += torch.sum(d < 2.0 * slab.d_max, dim=1)
    return count / n_kf > visible_threshold


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

def _stitch(full, sub):
    """Write a prefix slab (or opt dict) back over the full one."""
    n = (sub.capacity if isinstance(sub, G.GaussianSlab)
         else next(iter(sub.values())).exp_avg.shape[0])
    if isinstance(full, G.GaussianSlab):
        if n == full.capacity:
            return sub
        return G.GaussianSlab(**{
            f.name: torch.cat([getattr(sub, f.name), getattr(full, f.name)[n:]])
            for f in dataclasses.fields(full)})
    if n == full["xyz"].exp_avg.shape[0]:
        return sub
    return {k: adam.AdamState(*(torch.cat([a, b[n:]]) for a, b in zip(sub[k], full[k])))
            for k in full}


class SceneModel:
    """The mapper: add_keyframe, add_new_gaussians, optimization_loop,
    render_from_id, evaluate, on one ``device``."""

    def __init__(self, width: int, height: int, K, cfg: MapperConfig = MapperConfig(),
                 *, device=None, seed: int = 0, noise: Optional[Uniforms] = None):
        self.width = width
        self.height = height
        self.device = resolve(device)
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self.f = float(np.asarray(K, np.float32)[0, 0])
        self.cfg = cfg
        self.noise = noise if noise is not None else DeviceUniforms(seed, self.device)

        feat_dim = cfg.global_feat_dim + cfg.local_feat_dim
        self.slab = G.create_slab(min(cfg.initial_capacity, cfg.capacity),
                                  cfg.sh_degree, cfg.local_feat_dim,
                                  cfg.position_lr_init, self.device)
        self.opt = G.create_opt_state(self.slab)
        self.gfeat = create_global_feats(cfg.cluster_capacity, cfg.global_feat_dim,
                                         cfg.feat_lr, self.device)
        self.mlp = create_mlp_cov(feat_dim, torch.Generator().manual_seed(seed),
                                  self.device)
        self.mlp_opt = {k: adam.init_state(getattr(self.mlp, k)) for k in MLP_KEYS}
        self.mlp_lr = torch.tensor(cfg.mlp_cov_lr_init, device=self.device)
        self.pool = KF.create_pool(cfg.keyframe_capacity, self.device)
        self.cluster_state = clustering.create_cluster_state(cfg.voxel_table_size,
                                                             self.device)

        self.keyframes: list = []
        # pow2 bucket over the active high-water mark: training and renders
        # run on this prefix of the slab
        self._train_len = self.slab.capacity
        self.last_trained_id = -1
        self._np_rng = np.random.RandomState(seed)
        self._active_ids: list[int] = []
        self._has_gaussians = False
        self.inference_mode = False
        # calls that launch the compositor: one forward each, and a backward
        # for each training step; a dp step and a sharded render launch
        # one of each per slot
        self.n_train_steps = 0
        self.n_renders = 0
        self.n_dp_steps = 0
        self.n_sharded_renders = 0
        self._mesh = None                # the dp mesh (enable_mesh)
        self._dp_steps: dict = {}        # (w, h, is_important) -> dp train step
        self._sharded_render = None
        self._sharded_core_renders: dict = {}  # (w, h) -> sharded render_core

    def load_state(self, state) -> None:
        """Adopt a carried-over state (``state_io.scene_state_from_numpy``)."""
        for name in ("slab", "opt", "gfeat", "mlp", "mlp_opt", "mlp_lr", "pool",
                     "cluster_state"):
            setattr(self, name, getattr(state, name))
        self._train_len = state.train_len
        self._has_gaussians = bool(self.slab.active.any())

    @property
    def n_active_gaussians(self) -> int:
        return int(self.slab.num_active())

    def _K_at_lvl(self, lvl: int) -> torch.Tensor:
        K = self.K.clone()
        K[:2] *= 1.0 / (2 ** lvl)
        return K

    # -- keyframes -------------------------------------------------------
    def add_keyframe(self, kf: KF.KeyframeData, Rt_w2c: np.ndarray):
        idx = kf.index
        lr_pose = 0.0 if idx == 0 else self.cfg.lr_poses
        if kf.is_test:
            lr_pose = 1e-4
        KF.register_keyframe(
            self.pool, idx, torch.as_tensor(np.asarray(Rt_w2c, np.float32),
                                            device=self.device),
            lr_pose, self.cfg.lr_exposure, self.cfg.depth_loss_weight_init,
            kf.is_test,
        )
        while len(self.keyframes) <= idx:
            self.keyframes.append(None)
        self.keyframes[idx] = kf
        if idx not in self._active_ids:
            self._active_ids.append(idx)
        self._enforce_active_cap()

    def _enforce_active_cap(self):
        """Bound device-resident keyframes at ``max_active_keyframes`` by
        moving a random older one's payloads to the CPU."""
        cap = self.cfg.max_active_keyframes
        while len(self._active_ids) > max(cap, 1):
            # never evict the newest keyframe (it is the replay anchor)
            j = int(self._np_rng.randint(0, len(self._active_ids) - 1))
            kf = self.keyframes[self._active_ids.pop(j)]
            if kf is not None:
                for attr in ("image_pyr", "idepth_pyr", "conf_pyr"):
                    setattr(kf, attr, [x.cpu() for x in getattr(kf, attr)])
                kf.point_map = kf.point_map.cpu()
                kf.point_conf = kf.point_conf.cpu()

    @torch.no_grad()
    def set_keyframe_pose(self, idx: int, Rt_w2c) -> None:
        Rt = torch.as_tensor(np.asarray(Rt_w2c, np.float32), device=self.device)
        self.pool.r_w2c[idx] = Rt[:3, :2]
        self.pool.t_w2c[idx] = Rt[:3, 3]

    @torch.no_grad()
    def set_keyframe_poses_masked(self, Rt_w2c_cap: torch.Tensor, mask_cap: torch.Tensor):
        """Pose writeback of every slot where ``mask_cap`` (cap,) holds, from
        ``Rt_w2c_cap`` (cap, 4, 4), in one batched update."""
        m = mask_cap.to(self.device)
        Rt = Rt_w2c_cap.to(self.device, torch.float32)
        self.pool.r_w2c.copy_(torch.where(m[:, None, None], Rt[:, :3, :2], self.pool.r_w2c))
        self.pool.t_w2c.copy_(torch.where(m[:, None], Rt[:, :3, 3], self.pool.t_w2c))

    # -- the mesh --------------------------------------------------------
    def enable_mesh(self, mesh) -> None:
        """Train keyframe-data-parallel over ``mesh`` (``parallel/mesh.Mesh``,
        one axis "dp", its first device the model's): each optimization
        iteration trains ``mesh.size`` keyframes, one a slot, against the
        replicated scene (``parallel/dp.py``), and full-frame renders whose
        height is a multiple of 16 slots are sharded by row strips
        (``parallel/splats.py``).  ``None`` turns the mesh off."""
        if mesh is not None and mesh.home != self.device:
            raise ValueError(f"the mesh's first device {mesh.home} is not the "
                             f"scene's {self.device}")
        self._mesh = mesh
        self._dp_steps = {}
        self._sharded_render = None
        self._sharded_core_renders = {}

    @torch.no_grad()
    def render_sharded(self, keyframe_id: int):
        """The raw splats (no LOD fade or ``mlp_cov`` modulation) of the
        active Gaussians at full resolution, sharded by row strips over the
        mesh: (render (H, W, 4) RGB+D, alpha (H, W, 1)).  The JAX package
        masks rows by index below the active count; this masks by
        ``slab.active``, which is the same set until a prune leaves gaps."""
        from artdeco_tpu_torch.parallel.splats import make_row_sharded_render

        if self._mesh is None:
            raise ValueError("render_sharded needs a mesh (enable_mesh)")
        if self._sharded_render is None:
            self._sharded_render = make_row_sharded_render(
                self._mesh, self.width, self.height, self.cfg.sh_degree,
                eps2d=self.cfg.low_pass_filter_eps, axis="dp")
        s = self.slab
        self.n_sharded_renders += 1
        return self._sharded_render(
            s.xyz, s.rotation, torch.exp(s.scaling), torch.sigmoid(s.opacity[:, 0]),
            torch.cat([s.f_dc, s.f_rest], dim=1), KF.get_Rt(self.pool, keyframe_id),
            self._K_at_lvl(0), s.active)

    def _dp_step_for(self, w: int, h: int, is_important: bool):
        from artdeco_tpu_torch.parallel.dp import make_dp_train_step

        key = (w, h, is_important)
        if key not in self._dp_steps:
            self._dp_steps[key] = make_dp_train_step(self._mesh, self.cfg, w, h,
                                                     is_important=is_important)
        return self._dp_steps[key]

    def _optimization_step_dp(self, is_important: bool = True) -> dict:
        """One dp iteration: ``mesh.size`` keyframes of one pyramid level,
        trained at once.  The host RandomState is consumed as the JAX
        package consumes it: the branch draw (and the replay draw), the
        co-sampled keyframes, then the (B, 3) backgrounds."""
        B = self._mesh.size
        first = self.get_training_id() if (
            self._np_rng.rand() > self.cfg.use_last_frame_proba
            or self.last_trained_id == -1
        ) else len(self.keyframes) - 1
        lvl = self.keyframes[first].pyr_lvl
        same_lvl = [i for i in (self._active_ids or range(len(self.keyframes)))
                    if self.keyframes[i].pyr_lvl == lvl]
        # without replacement where there are enough keyframes (a duplicate
        # averages into its row, leaving a slot's work wasted)
        others = [i for i in same_lvl if i != first]
        if len(others) >= B - 1:
            sel = self._np_rng.choice(len(others), B - 1, replace=False)
            ids = [first] + [others[int(j)] for j in sel]
        else:
            ids = [first] + [same_lvl[self._np_rng.randint(0, len(same_lvl))]
                             for _ in range(B - 1)]
        s = 2 ** lvl
        gts, monos = zip(*[self._device_kf(i, lvl) for i in ids])
        bg = torch.as_tensor(self._np_rng.rand(B, 3).astype(np.float32), device=self.device)
        step = self._dp_step_for(self.width // s, self.height // s, is_important)
        # the whole slab, as the JAX package's dp step trains it: the
        # scaling regulariser's mean runs over the rows it is given, so the
        # training prefix would change the loss the parity test holds
        (self.slab, self.opt, self.gfeat, self.mlp, self.mlp_opt, self.mlp_lr,
         self.pool, metrics) = step(
            self.slab, self.opt, self.gfeat, self.mlp, self.mlp_opt, self.mlp_lr,
            self.pool, ids, gts, monos, self._K_at_lvl(lvl), bg,
            is_test=[bool(self.keyframes[i].is_test) for i in ids])
        self.n_dp_steps += 1
        self.last_trained_id = ids[0]
        return metrics

    # -- rendering -------------------------------------------------------
    @torch.no_grad()
    def render_from_id(self, keyframe_id: int, pyr_lvl: int = 0, bg=None) -> dict:
        if bg is None:
            bg = torch.zeros(3, device=self.device)
        s = 2 ** pyr_lvl
        w, h = self.width // s, self.height // s
        args = (self.slab.prefix(self._train_len), self.gfeat.val, self.mlp,
                KF.get_Rt(self.pool, keyframe_id), self.pool.exposure[keyframe_id],
                self._K_at_lvl(pyr_lvl))
        bg = torch.as_tensor(bg, device=self.device)
        if self._mesh is not None and h % (16 * self._mesh.size) == 0:
            from artdeco_tpu_torch.parallel.splats import make_row_sharded_render_core

            if (w, h) not in self._sharded_core_renders:
                self._sharded_core_renders[w, h] = make_row_sharded_render_core(
                    self._mesh, w, h, self.cfg.sh_degree, self.cfg.low_pass_filter_eps,
                    self.cfg.cluster_capacity, axis="dp")
            self.n_sharded_renders += 1
            return self._sharded_core_renders[w, h](*args, bg)
        self.n_renders += 1
        return render_core(*args, w, h, bg, self.cfg.sh_degree,
                           self.cfg.low_pass_filter_eps, self.cfg.cluster_capacity)

    # -- training --------------------------------------------------------
    def get_training_id(self) -> int:
        if self._active_ids:
            return int(self._active_ids[self._np_rng.randint(0, len(self._active_ids))])
        return int(self._np_rng.randint(0, len(self.keyframes)))

    def _presample_iters(self, n_iters: int, finetuning: bool = False):
        """Host keyframe + background sampling, consuming the RandomState
        exactly as the JAX package does (branch draw, maybe a randint, then
        the 3-vector background)."""
        ids, bgs = [], []
        for _ in range(n_iters):
            if (self._np_rng.rand() > self.cfg.use_last_frame_proba
                    or self.last_trained_id == -1 or finetuning):
                kid = self.get_training_id()
            else:
                kid = len(self.keyframes) - 1
            ids.append(kid)
            self.last_trained_id = kid
            bgs.append(self._np_rng.rand(3).astype(np.float32))
        return ids, bgs

    def _device_kf(self, keyframe_id: int, lvl: int):
        kf = self.keyframes[keyframe_id]
        return (kf.image_pyr[lvl].to(self.device),
                kf.idepth_pyr[lvl].to(self.device))

    def train_step(self, keyframe_id: int, bg: np.ndarray, is_important: bool) -> dict:
        """One training iteration on one keyframe, over the training
        bucket's prefix of the slab."""
        kf = self.keyframes[keyframe_id]
        lvl = kf.pyr_lvl
        s = 2 ** lvl
        gt, mono = self._device_kf(keyframe_id, lvl)
        n = self._train_len
        (sub, sub_opt, self.gfeat, self.mlp, self.mlp_opt, self.mlp_lr,
         self.pool, metrics, _) = _train_iter(
            self.slab.prefix(n), {k: adam.AdamState(*(x[:n] for x in st))
                                  for k, st in self.opt.items()},
            self.gfeat, self.mlp, self.mlp_opt, self.mlp_lr, self.pool,
            keyframe_id, gt, mono, self._K_at_lvl(lvl),
            torch.as_tensor(bg, device=self.device), bool(kf.is_test),
            self.width // s, self.height // s, is_important, self.cfg,
        )
        self.slab = _stitch(self.slab, sub)
        self.opt = _stitch(self.opt, sub_opt)
        self.n_train_steps += 1
        return metrics

    def optimization_loop(self, n_iters: int, is_important: bool = True,
                          finetuning: bool = False) -> Optional[dict]:
        """A burst of ``n_iters`` iterations; returns the last metrics."""
        if not self._has_gaussians or not self.keyframes:
            return None
        m = None
        if self._mesh is not None:
            for _ in range(n_iters):
                m = self._optimization_step_dp(is_important=is_important)
            return m
        ids, bgs = self._presample_iters(n_iters, finetuning=finetuning)
        for kid, bg in zip(ids, bgs):
            m = self.train_step(kid, bg, is_important)
        return m

    # -- densification ---------------------------------------------------
    def add_new_gaussians(self, keyframe_id: int = -1) -> Optional[int]:
        if keyframe_id < 0:
            keyframe_id = len(self.keyframes) - 1
        kf = self.keyframes[keyframe_id]
        if kf.is_test:
            return None
        has_scene = self._has_gaussians
        render_rgb = self.render_from_id(keyframe_id)["render"] if has_scene else None
        kf_pm = kf.point_map.to(self.device)
        new_fields, new_valid, centre_w = densify_all_lods_core(
            kf.image_pyr[0].to(self.device), render_rgb, kf_pm[None, ..., 2],
            kf.point_conf.to(self.device)[None], self.pool, keyframe_id, self.f,
            self.noise, self.width, self.height,
            self.cfg.new_budget // len(LODS), self.cfg,
            (self.cfg.sh_degree + 1) ** 2, self.cfg.local_feat_dim,
        )

        # cluster assignment (voxel majority vote)
        self.cluster_state, upd_cls, new_cls, _ = clustering.update_clusters(
            self.cluster_state, self.slab.xyz, self.slab.cls_id, self.slab.active,
            new_fields["xyz"], new_valid, self.cfg.voxel_size,
            self.cfg.voxel_table_size, self.cfg.cluster_capacity,
        )
        self.slab = dataclasses.replace(self.slab, cls_id=upd_cls)
        new_fields["cls_id"] = new_cls

        # prune before insert (opacity / screen size), on the bucket prefix
        n = self._train_len
        if has_scene:
            keep = densify_prune_keep(self.slab.prefix(n), centre_w, self.f, self.width)
            self._prune_prefix(keep)

        # grow the slab when nearly full; one host readback for the counts
        act = self.slab.active
        hw = int(torch.nonzero(act).max()) + 1 if bool(act.any()) else 0
        n_act, n_new = int(act.sum()), int(new_valid.sum())
        cap = self.slab.capacity
        while n_act + n_new > 0.85 * cap and cap < self.cfg.capacity:
            cap = min(cap * 2, self.cfg.capacity)
        if cap != self.slab.capacity:
            self.slab, self.opt = G.grow(self.slab, self.opt, cap)
        self.slab, self.opt, _ = G.insert(self.slab, self.opt, new_fields, new_valid)

        # insert fills the lowest free slots, so the new high-water mark is
        # at most hw + n_inserted: bucket it to the next pow2 before weeding
        n_inserted = min(n_new, cap - n_act)
        hw_bound = min(hw + n_inserted, cap)
        want_len = min(max(self._pow2(hw_bound), self.cfg.initial_capacity), cap)
        self._train_len = max(self._train_len, want_len)

        self.weed_out_gaussians()
        self._has_gaussians = self._has_gaussians or n_inserted > 0
        return n_inserted

    def _prune_prefix(self, keep: torch.Tensor) -> None:
        active = self.slab.active.clone()
        active[: keep.shape[0]] &= keep
        self.slab = dataclasses.replace(self.slab, active=active)

    @staticmethod
    def _pow2(n: int, lo: int = 1024) -> int:
        c = lo
        while c < n:
            c *= 2
        return c

    def weed_out_gaussians(self):
        keep = weed_keep(self.slab.prefix(self._train_len),
                         KF.cam_centres(self.pool), self.pool.used,
                         self.cfg.visible_threshold)
        self._prune_prefix(keep)

    # -- loop closure ----------------------------------------------------
    def rigid_transform_gs(self, old_c2ws, new_c2ws) -> None:
        """Move every Gaussian with its keyframe's pose correction; old/new
        (Kf, 4, 4) camera-to-world, Kf >= the keyframe count (rows past
        Kf are identity)."""
        cap = self.cfg.keyframe_capacity
        old = torch.as_tensor(old_c2ws, dtype=torch.float32, device=self.device)
        new = torch.as_tensor(new_c2ws, dtype=torch.float32, device=self.device)
        if old.shape[0] != cap or new.shape[0] != cap:
            eye = torch.eye(4, device=self.device).repeat(cap, 1, 1)
            o, n_ = eye.clone(), eye.clone()
            o[: old.shape[0]] = old
            n_[: new.shape[0]] = new
            old, new = o, n_
        self.slab = G.rigid_transform(self.slab, old, new)

    # -- evaluation ------------------------------------------------------
    @torch.no_grad()
    def harmonize_test_exposure(self):
        expo = self.pool.exposure
        n = len(self.keyframes)
        for i, kf in enumerate(self.keyframes):
            if kf is not None and kf.is_test:
                im = i - 1 if i != 0 else 1
                ip = i + 1 if i != n - 1 else n - 2
                expo[i] = (expo[im] + expo[ip]) / 2.0

    @torch.no_grad()
    def evaluate(self, with_lpips: bool = False) -> dict:
        """Mean PSNR / SSIM / visible count / active count over the test
        keyframes, rendered at map resolution; with ``with_lpips`` also the
        mean LPIPS (``eval.lpips.get_default_lpips``)."""
        self.harmonize_test_exposure()
        metrics = {"PSNR": 0.0, "SSIM": 0.0, "Render": 0.0, "GS": 0.0}
        if with_lpips:
            from artdeco_tpu_torch.eval.lpips import get_default_lpips

            lpips_fn = get_default_lpips()
            metrics["LPIPS"] = 0.0
        n_test = 0
        n_active = float(self.slab.num_active())
        for kf in self.keyframes:
            if kf is None or not kf.is_test:
                continue
            gt = kf.image_pyr[0].to(self.device)
            pkg = self.render_from_id(kf.index, pyr_lvl=0)
            img = pkg["render"]
            metrics["PSNR"] += float(losses.psnr(img, gt))
            metrics["SSIM"] += float(fused_ssim(img, gt))
            if with_lpips:
                metrics["LPIPS"] += float(lpips_fn(img, gt))
            metrics["Render"] += float(torch.sum(pkg["visibility"]))
            metrics["GS"] += n_active
            n_test += 1
        metrics = {k: v / n_test for k, v in metrics.items()} if n_test else {}
        metrics["n_test_frames"] = n_test
        return metrics

    # -- finetuning / inference -------------------------------------------
    def finetune_epoch(self):
        """Reset the optimizer states and learning rates, then one pass of
        random keyframe replay as long as the keyframe count."""
        cfg = self.cfg
        self.opt = G.create_opt_state(self.slab)
        self.slab = dataclasses.replace(
            self.slab, xyz_lr=torch.full((self.slab.capacity,), cfg.position_lr_init,
                                         device=self.device))
        self.mlp_opt = {k: adam.init_state(getattr(self.mlp, k)) for k in MLP_KEYS}
        self.mlp_lr = torch.tensor(cfg.mlp_cov_lr_init, device=self.device)
        self.gfeat = GlobalFeats(val=self.gfeat.val,
                                 lr=torch.full_like(self.gfeat.lr, cfg.feat_lr),
                                 opt=adam.init_state(self.gfeat.val))
        self.optimization_loop(len(self.keyframes), finetuning=True)

    def enable_inference_mode(self):
        self.inference_mode = True

    def save(self, path: str, reconstruction_time: float = 0.0, n_frames: int = 0) -> dict:
        from artdeco_tpu_torch.mapper.scene_io import save_scene

        return save_scene(self, path, reconstruction_time, n_frames)
