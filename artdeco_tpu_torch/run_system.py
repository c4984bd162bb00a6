"""End-to-end entry point of the PyTorch port (the ``run_system.py`` CLI).

    python -m artdeco_tpu_torch.run_system -s synthetic:// -d synthetic \
        --model_size full --accurate_loop_closure --test_hold 8 -m out/ [--device cpu]
    python -m artdeco_tpu_torch.run_system -s synthetic:// -d synthetic --oracle \
        --test_hold 8 -m out/
    python -m artdeco_tpu_torch.run_system -s /data/scene [--calib calib.yaml] -m out/
    python -m artdeco_tpu_torch.run_system -s /data/rgbd_dataset_freiburg1_desk -d tum \
        --downsampling 2 --test_hold 30 -m out/
    python -m artdeco_tpu_torch.run_system -s /data/garden -d colmap --downsampling 2 -m out/

Streams the dataset through tracking, the backend and the mapper on the GPU
(or on ``--device``), then writes trajectories, metrics and the scene under
``-m``.  ``-d`` picks the dataset: an image folder (``selfCaptured``, the
default; read as a COLMAP scene when ``<source>/sparse/0`` holds a model),
a TUM RGB-D sequence (``tum``), a COLMAP scene (``colmap``) or the
procedural stream (``synthetic``).  Frames on disk come from the native C++
loader where it applies.  The runner is MASt3R (``--model_size full``: ViT-L in bf16;
``tiny``: the test width in float32) with the weights of
``--checkpoint_path`` (a released ``.pth``, or ``.safetensors`` through the
``safetensors`` package) or, when there is no such file, seeded random
weights; or, with ``--oracle``, the synthetic dataset's ground-truth
pointmaps.  ``--n_devices N`` runs the mapper and the backend's GN over the
first N cards (``System.enable_mesh``; with ``--device cpu``, N slots on the
CPU).  The JAX package's pre-converted flax ``.npz`` checkpoints and the web
viewer are not ported.
"""

import os

import numpy as np


def _mast3r_runner(args, config, device):
    import torch

    from artdeco_tpu_torch.models import mast3r as M
    from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner

    cfg = (M.MASt3RConfig() if args.model_size == "full"
           else M.tiny_config(compute_dtype=torch.float32))
    path = args.checkpoint_path or ""
    sd = None
    if os.path.isfile(path):
        if path.endswith(".npz"):
            raise NotImplementedError("flax .npz checkpoints are not ported: pass the "
                                      "released .pth or .safetensors file")
        if path.endswith(".safetensors"):
            from safetensors.torch import load_file

            sd = load_file(path)
        else:
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
            sd = ckpt.get("model", ckpt)
        print(f"loaded MASt3R weights from {path}")
    else:
        print(f"WARNING: no checkpoint at {path}; "
              "running with random weights (tracking will be meaningless)")
    return Mast3rRunner.create(cfg, match_cfg=config["matching"], state_dict=sd,
                               device=device)


def main(argv=None):
    from artdeco_tpu_torch.dataio.args import get_args
    from artdeco_tpu_torch.dataio.dataset import load_dataset
    from artdeco_tpu_torch.device import float32_policy, resolve
    from artdeco_tpu_torch.runtime.system import System, stream_slam_images
    from artdeco_tpu_torch.utils.config import load_config

    args = get_args(argv)
    if args.viewer_mode == "web":
        raise NotImplementedError("--viewer_mode web: the viewers are not ported")
    device = resolve(args.device)
    float32_policy()
    np.random.seed(0)
    config = load_config(args.config)
    dataset = load_dataset(args)
    print(f"dataset: {len(dataset)} frames | slam {dataset.W_slam}x{dataset.H_slam}"
          f" | map {dataset.W_map}x{dataset.H_map} | device {device}")

    if args.oracle:
        from artdeco_tpu_torch.models.oracle import OracleRunner

        runner = OracleRunner((dataset.H_slam, dataset.W_slam), dataset.K_slam,
                              config["matching"], device=device)
        if dataset.Twc_gt is None:
            raise SystemExit("--oracle requires ground-truth poses")
        # the oracle finds a frame by its bytes: register the SLAM images
        # the stream will deliver (the native loader's, where it runs)
        for i, slam in enumerate(stream_slam_images(dataset)):
            T = np.ones(8, np.float32)
            T[:7] = dataset.Twc_gt[i]
            runner.register(slam, i, T)
    else:
        runner = _mast3r_runner(args, config, device)

    system = System(args, config, dataset, runner, device=device)
    if system.auto_calib is not None:
        print(f"auto-calibration: {system.auto_calib}")
    system.run()
    print(f"loader: {system.loader}")
    for _ in getattr(args, "save_at_finetune_epoch", []) or []:
        system.finetune(1)
    meta = system.save(args.model_path or "output")
    print(f"done: {meta['n_frames']} frames, {meta['n_keyframes']} keyframes, "
          f"{meta['n_gaussians']} gaussians, {meta['FPS']:.2f} FPS")
    if meta.get("trajectory"):
        print("trajectory:", meta["trajectory"])
    return meta


if __name__ == "__main__":
    main()
