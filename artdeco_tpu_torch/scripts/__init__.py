"""The port's run-inspection scripts, each the counterpart of the JAX
package's ``scripts/<same name>.py`` with its flags and outputs:

    python -m artdeco_tpu_torch.scripts.visualize_gs RUN_DIR [--frames 60 --mode splat]
    python -m artdeco_tpu_torch.scripts.visualize_pointmap pts.npy [--window 0 4]
    python -m artdeco_tpu_torch.scripts.traj traj.txt [-o traj.ply]
    python -m artdeco_tpu_torch.scripts.tum_pose_to_ply traj.txt [-o poses.ply]
    python -m artdeco_tpu_torch.scripts.compare_pose a.txt b.txt [--max_dt 0.02]
    python -m artdeco_tpu_torch.scripts.scannetpp_check ROOT | -s SCENE -d tum
    python -m artdeco_tpu_torch.scripts.test_sim3
"""
