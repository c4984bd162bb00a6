"""CLI flags: host copy of ``artdeco_tpu/dataio/args.py`` (``get_args``).

The flags and their defaults are the JAX package's, so a command line
means the same to both entry points (``tests/test_torch_system.py`` holds
them equal).  The port adds ``--device``: the torch device the system runs
on (default: the CUDA device).  Flags of parts the port has not ported yet
are accepted and raise where they would take effect.
"""

from __future__ import annotations

import argparse


def get_args(argv=None):
    p = argparse.ArgumentParser("artdeco-tpu")
    # data
    p.add_argument("-s", "--source_path", type=str, default="synthetic://")
    p.add_argument("-i", "--images_dir", type=str, default="images")
    p.add_argument("--downsampling", type=float, default=1.0)
    p.add_argument("--max_size_slam", type=int, default=512)
    p.add_argument("--start_at", type=int, default=0)
    p.add_argument("--end_at", type=int, default=0)
    p.add_argument("--seq_length", type=int, default=0)
    p.add_argument("--image_sampling", type=int, default=0)
    p.add_argument("--save_lidar_ply", action="store_true", default=False)
    p.add_argument("-d", "--dataset_name", type=str, default="selfCaptured")
    p.add_argument("--save_to_data_for_gsplat", action="store_true")
    # reference args.py:39 defines this store_true but never consumes it (the
    # main loop always rigid-transforms, run_system.py:194-227).  Here the
    # default matches the reference's actual behavior (ON) and the negative
    # flag gives the A/B debug scripts a real control.
    p.add_argument("--rigid_transform_gaussians", action="store_true",
                   default=True)
    p.add_argument("--no_rigid_transform_gaussians", action="store_false",
                   dest="rigid_transform_gaussians")
    p.add_argument("--base_model", type=str, default="h3dgs")
    # learning rates
    p.add_argument("--lr_poses", type=float, default=1e-4)
    p.add_argument("--lr_exposure", type=float, default=5e-4)
    p.add_argument("--lr_depth_scale_offset", type=float, default=1e-4)
    p.add_argument("--position_lr_init", type=float, default=5e-5)
    p.add_argument("--position_lr_decay", type=float, default=1 - 2e-5)
    p.add_argument("--mlp_cov_lr_init", type=float, default=0.004)
    p.add_argument("--mlp_cov_lr_decay", type=float, default=1 - 2e-5)
    p.add_argument("--feat_lr", type=float, default=0.004)
    p.add_argument("--feature_lr", type=float, default=0.005)
    p.add_argument("--opacity_lr", type=float, default=0.1)
    p.add_argument("--scaling_lr", type=float, default=0.01)
    p.add_argument("--rotation_lr", type=float, default=0.002)
    # render / loss
    p.add_argument("--low_pass_filter_eps", type=float, default=0.01)
    p.add_argument("--lambda_dssim", type=float, default=0.2)
    p.add_argument("--num_key_iterations", type=int, default=30)
    p.add_argument("--num_common_iterations", type=int, default=0)
    p.add_argument("--depth_loss_weight_init", type=float, default=1e-2)
    p.add_argument("--depth_loss_weight_decay", type=float, default=0.9)
    p.add_argument("--save_at_finetune_epoch", type=int, nargs="+", default=[])
    p.add_argument("--save_at_finetune_iteration", type=int, nargs="+",
                   default=[])
    p.add_argument("--use_last_frame_proba", type=float, default=0.2)
    # legacy pose-bootstrap suite knobs (accepted; suite is legacy)
    p.add_argument("--num_kpts", type=int, default=int(4096 * 1.5))
    p.add_argument("--match_max_error", type=float, default=2e-3)
    p.add_argument("--fundmat_samples", type=int, default=2000)
    p.add_argument("--min_num_inliers", type=int, default=100)
    p.add_argument("--num_keyframes_miniba_bootstrap", type=int, default=8)
    p.add_argument("--num_pts_miniba_bootstrap", type=int, default=2000)
    p.add_argument("--iters_miniba_bootstrap", type=int, default=200)
    p.add_argument("--enable_reboot", action="store_true")
    p.add_argument("--enable_scaling", action="store_true")
    p.add_argument("--fix_focal", action="store_true")
    p.add_argument("--num_prev_keyframes_miniba_incr", type=int, default=6)
    p.add_argument("--num_prev_keyframes_check", type=int, default=20)
    p.add_argument("--pnpransac_samples", type=int, default=2000)
    p.add_argument("--num_pts_miniba_incr", type=int, default=2000)
    p.add_argument("--iters_miniba_incr", type=int, default=20)
    # densification / scene
    p.add_argument("--scaling_reg_factor", type=float, default=0.0)
    p.add_argument("--voxel_size", type=float, default=0.1)
    p.add_argument("--visible_threshold", type=float, default=0.01)
    p.add_argument("--gs_add_ratio", type=float, default=0.3)
    p.add_argument("--rad_decay", type=float, default=5 ** 0.5)
    p.add_argument("--use_loop_closure", action="store_true")
    p.add_argument("--use_all_frames", action="store_true")
    p.add_argument("--init_focal", type=float, default=-1.0)
    p.add_argument("--init_fov", type=float, default=-1.0)
    # model-based self-calibration when no calib/focal/fov is given
    # (replaces the reference's GeoCalib/COLMAP path, DatasetBasic.py:112-273)
    p.add_argument("--auto_calib", action="store_true", default=True)
    p.add_argument("--no_auto_calib", dest="auto_calib", action="store_false")
    p.add_argument("--checkpoint_path", type=str,
                   default="./models/mast3r_vit_large.safetensors")
    # retrieval head + codebook (utils_mast3r.py:20-28 default path) and Pi3
    # weights for accurate loop closure (retrieval_database.py:169)
    p.add_argument("--retrieval_checkpoint_path", type=str,
                   default="./models/MASt3R_ViTLarge_BaseDecoder_512_"
                           "catmlpdpt_metric_retrieval_trainingfree.pth")
    p.add_argument("--pi3_checkpoint_path", type=str,
                   default="./models/model.safetensors")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--local_feat_dim", type=int, default=32)
    p.add_argument("--global_feat_dim", type=int, default=32)
    p.add_argument("--pyr_levels", type=int, default=2)
    p.add_argument("--init_proba_scaler", type=float, default=2.0)
    p.add_argument("--max_active_keyframes", type=int, default=400)
    # eval / io
    p.add_argument("--test_hold", type=int, default=-1)
    p.add_argument("--test_frequency", type=int, default=-1)
    p.add_argument("--display_runtimes", action="store_true")
    # jax.profiler trace of the streaming loop (SURVEY §5 tracing hooks);
    # view with tensorboard or xprof
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("-m", "--model_path", default="")
    p.add_argument("--save_every", default=-1, type=int)
    p.add_argument("--save_point_could", action="store_true")
    # device placement flags kept for CLI parity (single host + mesh here)
    p.add_argument("--device_frontend", default="tpu:0")
    p.add_argument("--device_backend", default="tpu:0")
    p.add_argument("--device_mapper", default="tpu:0")
    p.add_argument("--device_shared", default="cpu")
    # multi-device: a dp mesh over the first N cards (the mapper trains N
    # keyframes an iteration, row-strip sharded renders, edge-sharded GN;
    # parallel/), the counterpart of the reference's per-stage --device_*
    # placement (args.py:156-159)
    p.add_argument("--n_devices", type=int, default=1)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--viewer_mode", choices=["local", "server", "web", "none"],
                   default="none")
    p.add_argument("--ip", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=6009)
    # vslam knobs
    p.add_argument("--optimize_focal", action="store_true")
    p.add_argument("--point_fusion_frontend", action="store_true")
    p.add_argument("--covariance_filter", action="store_true")
    p.add_argument("--accurate_loop_closure", action="store_true")
    p.add_argument("--num_GBA", type=int, default=1)
    p.add_argument("--use_gt_pose", action="store_true")
    p.add_argument("--min_displacement", type=float, default=0.03)
    p.add_argument("--config", default="config/base.yaml")
    p.add_argument("--calib", default=None)
    p.add_argument("--use_colmap_calib", action="store_true")
    p.add_argument("--colmap_first_n", type=int, default=400)
    p.add_argument("--colmap_stride", type=int, default=4)
    # NOTE: store_false parity — passing --sync_hard DISABLES hard sync
    p.add_argument("--sync_hard", action="store_false")
    # overlapped runtime: mapper half of the pipeline on a worker thread
    # (the reference's 3-process overlap, run_system.py:105-110); passing
    # the flag DISABLES it — store_false like --sync_hard
    p.add_argument("--async_pipeline", action="store_false")
    # background AOT compile of all pipeline stages at startup
    # (runtime/prewarm.py); tri-state default: on for TPU backends
    p.add_argument("--prewarm", action="store_true", default=None)
    p.add_argument("--thres_keyframe", type=float, default=0.8)
    p.add_argument("--use_same_set_of_keyframes", action="store_true")
    # runtime extras (TPU rebuild)
    p.add_argument("--oracle", action="store_true",
                   help="use the ground-truth oracle pointmap runner "
                        "(synthetic datasets only)")
    p.add_argument("--model_size", choices=["tiny", "full"], default="full",
                   help="MASt3R size; tiny = untrained test network")
    # the port's own: the torch device (default: the CUDA device)
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on, e.g. cuda:0 or cpu (default: the GPU)")
    return p.parse_args(argv)
