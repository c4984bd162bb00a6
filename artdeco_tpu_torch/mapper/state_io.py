"""Carry a mapper state across from numpy arrays.

``scene_state_from_numpy`` turns the leaves of a JAX ``SceneModel`` (or of
any mapper), given as a nested dict of numpy arrays, into the port's
state, so that both packages can start from the same ``mlp_cov`` weights
and the same scene.  The dict's layout:

    slab:     {active, kf_id, cls_id, d_max, xyz, f_dc, f_rest, scaling,
               rotation, opacity, local_feat, xyz_lr}
    opt:      {<trained key>: {exp_avg, exp_avg_sq}}
    gfeat:    {val, lr, exp_avg, exp_avg_sq}
    mlp:      {w1, b1, w2, b2}
    mlp_opt:  {<w1|b1|w2|b2>: {exp_avg, exp_avg_sq}}
    mlp_lr:   scalar
    pool:     {r_w2c, t_w2c, exposure, lr_pose, lr_exposure,
               depth_loss_weight, is_test, used,
               opt_r|opt_t|opt_e: {exp_avg, exp_avg_sq}}
    cluster:  {voxel_cls, num_clusters}
    train_len: int (optional; the slab's capacity when absent)

This module only sees numpy: converting framework arrays is the caller's
job.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from artdeco_tpu_torch.mapper import clustering, gaussians as G, keyframe as KF
from artdeco_tpu_torch.mapper.scene_model import MLP_KEYS, GlobalFeats, MlpCov
from artdeco_tpu_torch.ops import adam


@dataclasses.dataclass
class SceneState:
    slab: G.GaussianSlab
    opt: G.SlabOptState
    gfeat: GlobalFeats
    mlp: MlpCov
    mlp_opt: dict
    mlp_lr: torch.Tensor
    pool: KF.KeyframePool
    cluster_state: clustering.ClusterState
    train_len: int


_INT_FIELDS = {"kf_id", "cls_id", "voxel_cls", "num_clusters"}
_BOOL_FIELDS = {"active", "is_test", "used"}


def _t(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _BOOL_FIELDS:
        dt = torch.bool
    elif name in _INT_FIELDS:
        dt = torch.int32
    else:
        dt = torch.float32
    return torch.as_tensor(a.copy(), dtype=dt, device=device)


def _adam(d: dict, device) -> adam.AdamState:
    return adam.AdamState(_t("m", d["exp_avg"], device), _t("v", d["exp_avg_sq"], device))


def scene_state_from_numpy(d: dict, device, train_len: Optional[int] = None) -> SceneState:
    """Build the port's mapper state from a nested dict of numpy arrays
    (layout in the module docstring) on ``device``."""
    slab = G.GaussianSlab(**{f.name: _t(f.name, d["slab"][f.name], device)
                             for f in dataclasses.fields(G.GaussianSlab)})
    opt = {k: _adam(d["opt"][k], device) for k in G.TRAINED_KEYS}
    gd = d["gfeat"]
    gfeat = GlobalFeats(val=_t("val", gd["val"], device), lr=_t("lr", gd["lr"], device),
                        opt=_adam(gd, device))
    mlp = MlpCov(**{k: _t(k, d["mlp"][k], device) for k in MLP_KEYS})
    mlp_opt = {k: _adam(d["mlp_opt"][k], device) for k in MLP_KEYS}
    pd = d["pool"]
    pool = KF.KeyframePool(
        **{f.name: (_adam(pd[f.name], device) if f.name.startswith("opt_")
                    else _t(f.name, pd[f.name], device))
           for f in dataclasses.fields(KF.KeyframePool)})
    cd = d["cluster"]
    cluster = clustering.ClusterState(
        voxel_cls=_t("voxel_cls", cd["voxel_cls"], device),
        num_clusters=_t("num_clusters", cd["num_clusters"], device))
    if train_len is None:
        train_len = int(d.get("train_len", slab.capacity))
    return SceneState(slab=slab, opt=opt, gfeat=gfeat, mlp=mlp, mlp_opt=mlp_opt,
                      mlp_lr=_t("mlp_lr", d["mlp_lr"], device), pool=pool,
                      cluster_state=cluster, train_len=train_len)
