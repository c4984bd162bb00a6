#!/usr/bin/env python3
"""Run the mapper stream of ``chip_smoke.py`` phase 3 at several seeds,
and time K1 on its scene.

    python3 scripts/mapper_seeds.py [ROOT] [--seeds 0 1 2]

ROOT is a checkout of this repository (default: this one).  Its
``artdeco_tpu_torch`` package is imported; the stream settings, K1's
inputs and the timing are this script's own ``chip_smoke.py``'s, so two
checkouts (a parent and a change) can be compared on one card by running
the script once per checkout, in turns.  For each seed it drives
``MapperStage`` over phase 3's 16-frame 512x384 synthetic stream (the seed
sets the scene model's initialisation and its random draws) and prints one
JSON line: the checkout, the seed, the test-frame PSNR and SSIM, the
active Gaussians, the mean ms per training iteration (host clock,
synchronised with the device around each burst), K2's launches, and K1's
device time (``chip_smoke.cuda_ms``) on the slot data of a training render
of the stream's last keyframe and on phase 4's random 10^5-Gaussian scene.
The first stream of a process also pays the warm-up of the allocator and
the libraries, as phase 3 does; its line says so.  Needs one CUDA device;
imports nothing of JAX.
"""

import argparse
import importlib.util
import json
import os
import sys
import time
import types

HERE = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def stream(cs, dev, seed: int, big) -> dict:
    import torch
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
    from artdeco_tpu_torch.mapper.config import MapperConfig
    from artdeco_tpu_torch.ops.splat import composite as C
    from artdeco_tpu_torch.runtime.system import MapperStage, exact_mapper_messages

    ds = SyntheticDataset(types.SimpleNamespace(test_hold=cs.TEST_HOLD,
                                                max_size_slam=cs.WIDTH),
                          n_frames=cs.N_FRAMES, width=cs.WIDTH, height=cs.HEIGHT)
    stage = MapperStage(ds, MapperConfig(), device=dev, seed=seed,
                        num_key_iterations=cs.KEY_ITERS,
                        num_common_iterations=cs.COMMON_ITERS)
    C.composite_bwd.launches = 0
    burst_s, iters = 0.0, 0
    for m in exact_mapper_messages(ds, important_every=2):
        stage.ingest(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage.train(m)
        torch.cuda.synchronize()
        burst_s += time.perf_counter() - t0
        iters += cs.KEY_ITERS if m["is_important"] else cs.COMMON_ITERS
    ev = stage.metrics()
    sm = stage.scene_model
    k1_ms = {what: cs.cuda_ms(lambda a=(p.slot_data.contiguous(), p.pad_starts, p.pad_counts,
                                        p.tiles_x, p.tiles_y): C.composite_fwd(*a))
             for what, p in (("stream", cs.train_view_slots(sm, sm.cfg, len(sm.keyframes) - 1)),
                             ("random_100000", big))}
    return dict(seed=seed, psnr=ev["metrics"]["PSNR"], ssim=ev["metrics"]["SSIM"],
                gaussians=ev["n_gaussians"], ms_per_iteration=1e3 * burst_s / iters,
                iterations=iters, k2_launches=C.composite_bwd.launches,
                k1_ms=k1_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    # this checkout's chip_smoke.py, ROOT's package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from artdeco_tpu_torch.mapper.config import MapperConfig
    from artdeco_tpu_torch.ops.splat import composite as C

    if not torch.cuda.is_available():
        print("mapper_seeds: no CUDA device", file=sys.stderr)
        return 2
    if not C.__file__.startswith(root):
        raise RuntimeError(f"imported {C.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lvl = MapperConfig().pyr_levels - 1
    big = cs.random_slots(dev, seed=2, n=cs.N_BIG, width=cs.WIDTH >> lvl,
                          height=cs.HEIGHT >> lvl)
    for i, seed in enumerate(args.seeds):
        res = stream(cs, dev, seed, big)
        print(json.dumps(dict(root=root, first_in_process=i == 0, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
