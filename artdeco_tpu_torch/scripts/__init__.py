"""The port's tools, each the counterpart of the JAX package's
``scripts/<same name>`` with its flags and outputs, without OpenCV.

Run-inspection:

    python -m artdeco_tpu_torch.scripts.visualize_gs RUN_DIR [--frames 60 --mode splat]
    python -m artdeco_tpu_torch.scripts.visualize_pointmap pts.npy [--window 0 4]
    python -m artdeco_tpu_torch.scripts.traj traj.txt [-o traj.ply]
    python -m artdeco_tpu_torch.scripts.tum_pose_to_ply traj.txt [-o poses.ply]
    python -m artdeco_tpu_torch.scripts.compare_pose a.txt b.txt [--max_dt 0.02]
    python -m artdeco_tpu_torch.scripts.scannetpp_check ROOT | -s SCENE -d tum
    python -m artdeco_tpu_torch.scripts.test_sim3

Data preparation:

    python -m artdeco_tpu_torch.scripts.rectify_tum --base_dir data [--scenes TUM/...]
    python -m artdeco_tpu_torch.scripts.downsampleImage IMAGES_DIR -o OUT [--factor 2]
    python -m artdeco_tpu_torch.scripts.img_summary DIR [DIR ...]
    python -m artdeco_tpu_torch.scripts.img2vid IMAGES_DIR [-o out.mp4 --fps 30]

Evaluation scripts on ``python -m artdeco_tpu_torch.run_system`` (from the
repository's root):

    python -m artdeco_tpu_torch.scripts.train_eval_all --data_root data [--dry_run]
    BASE_DIR=data/scenes artdeco_tpu_torch/scripts/run_debug_rigidtransform.sh
    BASE_DIR=data/scenes artdeco_tpu_torch/scripts/run_debug_norigidtransform.sh
"""
