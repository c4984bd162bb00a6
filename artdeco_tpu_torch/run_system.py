"""End-to-end entry point of the PyTorch port (the ``run_system.py`` CLI).

    python -m artdeco_tpu_torch.run_system -s synthetic:// -d synthetic --oracle \
        --test_hold 8 -m out/ [--device cpu]

Streams the dataset through tracking, the backend and the mapper on the GPU
(or on ``--device``), then writes trajectories, metrics and the scene under
``-m``.  Only the oracle runner (ground-truth pointmaps of the synthetic
dataset) is ported: the MASt3R runner and the web viewer raise.
"""

import numpy as np


def main(argv=None):
    from artdeco_tpu_torch.dataio.args import get_args
    from artdeco_tpu_torch.dataio.dataset import load_dataset
    from artdeco_tpu_torch.device import resolve
    from artdeco_tpu_torch.runtime.system import System
    from artdeco_tpu_torch.utils.config import load_config

    args = get_args(argv)
    if not args.oracle:
        raise NotImplementedError("only the --oracle runner is ported; MASt3R is not yet "
                                  "(ROADMAP.md queue 1, item 7)")
    if args.viewer_mode == "web":
        raise NotImplementedError("--viewer_mode web: the viewers are not ported")
    device = resolve(args.device)
    np.random.seed(0)
    config = load_config(args.config)
    dataset = load_dataset(args)
    print(f"dataset: {len(dataset)} frames | slam {dataset.W_slam}x{dataset.H_slam}"
          f" | map {dataset.W_map}x{dataset.H_map} | device {device}")

    from artdeco_tpu_torch.models.oracle import OracleRunner

    runner = OracleRunner((dataset.H_slam, dataset.W_slam), dataset.K_slam,
                          config["matching"], device=device)
    for i in range(len(dataset)):
        img, info = dataset[i]
        gt = info.get("Twc_gt")
        if gt is None:
            raise SystemExit("--oracle requires ground-truth poses")
        T = np.ones(8, np.float32)
        T[:7] = gt
        runner.register(dataset.transform.to_slam(img), i, T)

    system = System(args, config, dataset, runner, device=device)
    system.run()
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
