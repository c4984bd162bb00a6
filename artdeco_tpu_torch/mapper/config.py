"""Mapper hyperparameters.

Port of ``artdeco_tpu/mapper/config.py``: the same fields and defaults
(the defaults of record of the reference's ``dataloaders/args.py``), so a
configuration means the same in both packages.
"""

from __future__ import annotations

from typing import NamedTuple


class MapperConfig(NamedTuple):
    # learning rates
    lr_poses: float = 1e-4
    lr_exposure: float = 5e-4
    position_lr_init: float = 5e-5
    position_lr_decay: float = 1 - 2e-5
    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_decay: float = 1 - 2e-5
    feat_lr: float = 0.004
    feature_lr: float = 0.005
    opacity_lr: float = 0.1
    scaling_lr: float = 0.01
    rotation_lr: float = 0.002
    # render / loss
    low_pass_filter_eps: float = 0.01
    lambda_dssim: float = 0.2
    depth_loss_weight_init: float = 1e-2
    depth_loss_weight_decay: float = 0.9
    scaling_reg_factor: float = 0.0
    rad_decay: float = 5 ** 0.5
    # densification
    sh_degree: int = 3
    local_feat_dim: int = 32
    global_feat_dim: int = 32
    init_proba_scaler: float = 2.0
    gs_add_ratio: float = 0.3
    voxel_size: float = 0.1
    visible_threshold: float = 0.01
    pyr_levels: int = 2
    # schedule
    num_key_iterations: int = 30
    num_common_iterations: int = 0
    use_last_frame_proba: float = 0.2
    max_active_keyframes: int = 400
    # capacities
    capacity: int = 1 << 18            # max gaussian slots
    initial_capacity: int = 1 << 14    # starting slab size (doubles on demand)
    vis_budget_init: int = 1 << 15     # the JAX package's visible-set budget;
                                       # the port renders without one
    cluster_capacity: int = 1 << 14    # global_feat rows
    voxel_table_size: int = 1 << 16    # voxel hash buckets
    new_budget: int = 1 << 14          # max new gaussians per densify call
    keyframe_capacity: int = 2048
    adam_b1: float = 0.5
    adam_b2: float = 0.99
    adam_eps: float = 1e-15
