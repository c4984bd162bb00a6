"""End-to-end streaming FPS of the PyTorch/CUDA port on one NVIDIA GPU.

    python -m artdeco_tpu_torch.bench

The port's counterpart of the repository's ``bench.py``, which times the
JAX package: the same four parts in the same order, and the same one JSON
line on stdout, ``{"metric": "end_to_end_fps", "value", "unit",
"vs_baseline"}``.  Progress, the golden check and every measured number go
to stderr, each beside the card's name and power limit; the last stderr
line, ``bench summary: {...}``, holds them all as JSON.

1. ``golden_check``: the tile compositor's kernels (K1 forward, K2 backward
   through ``composite._TileComposite``) against ``composite_reference`` on
   a 48x32 scene of 60 Gaussians, forward and the four gradients.
2. ``device_speed_of_light``: chains of bf16 4096^3 matmuls, the card's
   measured ceiling.
3. ``bench_model``: the full MASt3R on seeded random weights, one encode and
   one pair decode with heads at 512x384: wall and device ms, FLOPs and
   TFLOP/s.
4. ``bench_pipeline``: the oracle pipeline on a 1024x576 synthetic stream
   (SLAM 512x288), 64 frames, 20/10 iterations, the mapper overlapped on
   its worker thread as ``System.run`` runs it.

End-to-end frame time = the pipeline's ms per frame + encode + decode (the
oracle stands in for the model inside the pipeline, so its cost is added
back).  Baseline: 30 FPS (BASELINE.md).  No released checkpoint is in the
repository: the model is timed on random weights (the same FLOPs and
layout).

Departures from ``bench.py``: the golden scene is drawn from a numpy
``RandomState`` and gated at tolerances measured on the card and on the
CPU (``bench.py``'s were loosened for TPU transcendentals); the ceiling is
timed on zero and on random operands (zeros draw less power on a GPU) and
the random one is returned; the model's FLOPs come from
``FlopCounterMode``, not XLA's cost analysis; the kernels are built and
loaded before the pipeline's clock starts (XLA's prewarm and compile cache
have no counterpart); the device is synchronised before the steady window
opens and after the worker closes; there is no refine-overflow line (K3 has
no drain); a diverged pipeline (keyframe pose error >= 0.05) exits non-zero.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from artdeco_tpu_torch.device import resolve

REPO = Path(__file__).resolve().parent.parent
BASELINE_FPS = 30.0            # BASELINE.md
PEAK_BF16_TFLOPS = 989.0       # H100 SXM, dense bf16 on the tensor cores (data sheet)
POSE_ERR_MAX = 0.05            # keyframe pose error against ground truth (Sim(3) log)
WARM_FRAMES = 12               # frames before the steady window
# the golden check's gates: the forward's max abs error over image and
# alpha, and the gradients' max error relative to the reference gradient's
# largest.  Measured: forward 1.2e-7 and gradients 3.8e-7 on the CPU (the
# plain versions; JAX's Pallas kernels in interpret mode 1.2e-7 and
# 4.2e-7), 1.8e-7 and 2.4e-7 with K1/K2 on an H100 80GB HBM3 (700 W);
# broken ordering, indexing or a VJP sign shows at 1e-1 and above
GOLDEN_FWD_TOL = 1e-5
GOLDEN_BWD_TOL = 1e-5


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


@functools.lru_cache(maxsize=None)
def card_label(device: str = "cuda:0") -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads the limit
    ("power limit not read" where it cannot), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        lines = res.stdout.strip().splitlines() if res.returncode == 0 else []
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    limit = (lines[min(device.index or 0, len(lines) - 1)].strip() if lines
             else "power limit not read")
    return f"{name}, {limit}"


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, n: int, device) -> float:
    """Mean ms a call over ``n`` back-to-back calls after one warm-up call,
    the device synchronised before and after the window: by CUDA events
    around the window on the card, by the host clock on the CPU."""
    fn()
    sync(device)
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize(device)
        return e0.elapsed_time(e1) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e3 * (time.perf_counter() - t0) / n


def device_busy_ms(fn, n: int, device) -> tuple:
    """The device's busy ms a call over ``n`` calls under ``torch.profiler``
    (the sum of the device time of its kernels, copies and fills), and the
    count of those a call.  Unlike CUDA events around the calls, this does
    not count the time the device waits for the host to launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
    # a record_function range (a tracer span) projected onto the device is not work
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return (sum(e.self_device_time_total for e in ops) / 1e3 / n,
            sum(e.count for e in ops) / n)


# ---------------------------------------------------------------------------
# 1. The tile compositor's kernels against the plain full-image reference
# ---------------------------------------------------------------------------

def golden_scene(seed: int = 1, width: int = 48, height: int = 32, n: int = 60) -> dict:
    """``bench.py``'s golden scene drawn from ``np.random.RandomState(seed)``:
    60 Gaussians away from the border, sizes 1-2.5 px (bench.py draws sx and
    sy from one key, so they are equal here too), correlations +-0.3,
    opacities 0.3-0.95, 4 channels in [0, 1], and the loss's cotangents
    (normal) for the image and alpha.  float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    means2d = np.stack([rng.uniform(6.0, width - 6.0, n),
                        rng.uniform(6.0, height - 6.0, n)], -1).astype(f32)
    s = rng.uniform(1.0, 2.5, n).astype(f32)
    rho = rng.uniform(-0.3, 0.3, n).astype(f32)
    opac = rng.uniform(0.3, 0.95, n).astype(f32)
    channels = rng.uniform(0.0, 1.0, (n, 4)).astype(f32)
    g_img = rng.standard_normal((height, width, 4)).astype(f32)
    g_alpha = rng.standard_normal((height, width)).astype(f32)
    c00, c01, c11 = s * s, rho * s * s, s * s
    det = c00 * c11 - c01 * c01
    conics = np.stack([c11 / det, -c01 / det, c00 / det], -1).astype(f32)
    radii = np.ceil(3.0 * np.sqrt(np.stack([c00, c11], -1))).astype(f32)
    return dict(means2d=means2d, conics=conics, opac=opac, channels=channels, radii=radii,
                g_img=g_img, g_alpha=g_alpha, width=width, height=height)


def tile_render(means2d, conics, opac, channels, radii, width: int, height: int):
    """The renderer's path from 2D Gaussians to an image: tile binning
    (4x4-tile footprints), the slot gather, and ``tile_composite`` (K1, and
    K2 in the backward).  Returns (image (H, W, C), alpha (H, W))."""
    from artdeco_tpu_torch.ops.splat import api, binning, composite

    n, c = channels.shape
    tiles_x, tiles_y = -(-width // binning.TILE), -(-height // binning.TILE)
    bins = binning.build_tile_bins(means2d.detach(), radii, tiles_x, tiles_y, kx=4, ky=4)
    packed = torch.cat([means2d, conics, opac[:, None], means2d.new_zeros(n, 2), channels,
                        means2d.new_zeros(n, composite.C_MAX - c)], -1)
    slot_data = api.SlotGather.apply(packed, bins.slot_gauss, bins.slot_valid,
                                     bins.gauss_slots)
    out = composite.tile_composite(slot_data, bins.pad_starts, bins.pad_counts,
                                   tiles_x, tiles_y)
    img = (out.reshape(tiles_y, tiles_x, 16, 16, composite.C_MAX).permute(0, 2, 1, 3, 4)
           .reshape(tiles_y * 16, tiles_x * 16, composite.C_MAX))[:height, :width]
    return img[..., :c], img[..., composite.C_MAX - 1]


def golden_check(device=None) -> dict:
    """``tile_render`` against ``composite_reference`` on ``golden_scene``
    on ``device`` (default: the card): the forward's max abs error over
    image and alpha, and the four gradients' (means2d, conics, opacities,
    channels) max abs error relative to the reference gradient's largest
    magnitude.  Prints them and raises SystemExit when either is over its
    gate; returns them."""
    from artdeco_tpu_torch.ops.splat import composite

    dev = resolve(device)
    scene = golden_scene()
    w, h = scene["width"], scene["height"]
    t = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()
         if isinstance(v, np.ndarray)}
    params = [t[k].clone().requires_grad_(True)
              for k in ("means2d", "conics", "opac", "channels")]
    ref_params = [p.detach().clone().requires_grad_(True) for p in params]
    img, alpha = tile_render(*params, t["radii"], w, h)
    ref_img, ref_alpha = composite.composite_reference(*ref_params, w, h)
    fwd_err = max(float((img - ref_img).detach().abs().max()),
                  float((alpha - ref_alpha).detach().abs().max()))
    gt = torch.autograd.grad((img * t["g_img"]).sum() + (alpha * t["g_alpha"]).sum(), params)
    gr = torch.autograd.grad((ref_img * t["g_img"]).sum() + (ref_alpha * t["g_alpha"]).sum(),
                             ref_params)
    bwd_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-6)) for a, b in zip(gt, gr))
    ok = fwd_err < GOLDEN_FWD_TOL and bwd_err < GOLDEN_BWD_TOL
    log(f"golden[{card_label(str(dev))}]: {'PASSED' if ok else 'FAILED'} "
        f"fwd_err={fwd_err:.2e} (gate {GOLDEN_FWD_TOL:.0e}) "
        f"bwd_relerr={bwd_err:.2e} (gate {GOLDEN_BWD_TOL:.0e})")
    if not ok:
        raise SystemExit("on-device compositor golden check FAILED")
    return {"fwd_err": fwd_err, "bwd_err": bwd_err}


# ---------------------------------------------------------------------------
# 2. The card's matmul ceiling
# ---------------------------------------------------------------------------

def _chain_s(a, b, iters: int) -> float:
    """Seconds a matmul of a chain o <- o @ b, started from a."""
    torch.matmul(a, b)
    torch.cuda.synchronize(a.device)
    t0 = time.perf_counter()
    o = a
    for _ in range(iters):
        o = torch.matmul(o, b)
    torch.cuda.synchronize(a.device)
    return (time.perf_counter() - t0) / iters


def device_speed_of_light(iters: int = 16, device=None, record: dict = None) -> float:
    """The card's measured bf16 matmul ceiling in TFLOP/s: a chain of
    ``iters`` 4096^3 ``torch.matmul`` calls (a library call on purpose: this
    measures the card, not a kernel of the repository), timed on zero
    operands as ``bench.py`` does and on seeded normal operands scaled by
    1/sqrt(n), which keep the chain's magnitude and draw the power real
    data draws.  Returns the random operands' ceiling."""
    dev = resolve(device)
    n = 4096
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for what, (a, b) in (
            ("zeros", (torch.zeros(n, n, dtype=torch.bfloat16, device=dev),) * 2),
            ("random", tuple(torch.randn(n, n, generator=g, device=dev).mul_(n ** -0.5)
                             .to(torch.bfloat16) for _ in range(2)))):
        dt = _chain_s(a, b, iters)
        out[what] = (1e3 * dt, 2 * n ** 3 / dt / 1e12)
    sol = out["random"][1]
    log(f"device speed-of-light [{card_label(str(dev))}]: bf16 {n}^3 matmul, zero operands "
        f"{out['zeros'][0]:.3f} ms -> {out['zeros'][1]:.1f} TFLOP/s; random operands "
        f"{out['random'][0]:.3f} ms -> {sol:.1f} TFLOP/s "
        f"({100 * sol / PEAK_BF16_TFLOPS:.1f}% of the H100's published "
        f"{PEAK_BF16_TFLOPS:.0f} TFLOP/s)")
    if record is not None:
        record.update(sol_zeros_tflops=out["zeros"][1], sol_zeros_ms=out["zeros"][0],
                      sol_tflops=sol, sol_ms=out["random"][0])
    return sol


# ---------------------------------------------------------------------------
# 3. The full MASt3R: one encode and one pair decode
# ---------------------------------------------------------------------------

def _sdpa_cpu_flops(query, key, value, *args, out_shape=None, **kwargs) -> int:
    """FLOPs of the CPU attention kernel, as FlopCounterMode counts the
    card's: 2 per multiply-add of Q K^T and of P V."""
    b, h, s_q, d = query
    s_k, d_v = key[2], value[3]
    return 2 * b * h * s_q * s_k * (d + d_v)


def model_flops(runner, img, feat_f, pos_f, feat_k, pos_k, hw) -> tuple:
    """FLOPs of one ``encode_image`` of ``img`` and one pair ``decode``
    with heads at ``hw``, counted by ``torch.utils.flop_counter.FlopCounterMode``:
    matmuls, convolutions and attention, 2 per multiply-add (the CPU's
    attention kernel counted as the card's).  Elementwise work (norms,
    activations, softmax, RoPE, resampling) is not counted, where XLA's
    cost analysis counts it.  Returns (encode, decode)."""
    from torch.utils.flop_counter import FlopCounterMode

    mapping = {torch.ops.aten._scaled_dot_product_flash_attention_for_cpu: _sdpa_cpu_flops}
    counts = []
    for fn in (lambda: runner.encode_image(img),
               lambda: runner.decode(feat_f, pos_f, feat_k, pos_k, hw)):
        with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
            fn()
        counts.append(fc.get_total_flops())
    return counts[0], counts[1]


def bench_model(h: int = 384, w: int = 512, iters: int = 8, device=None,
                record: dict = None) -> tuple:
    """The model's cost on a tracked frame: one encode and one pair decode
    with heads (the keyframe side cached).  The matching cascade is not
    timed here: the pipeline's oracle runs the same cascade.  Each is timed
    as ``iters`` back-to-back calls between two ``torch.cuda.synchronize``
    (wall), and as the device's busy time (``device_busy_ms``: where the
    two differ, the host paces the model).  The model is ``MASt3RConfig()``: ViT-L with
    a bf16 trunk.

    Returns (t_encode_s, t_decode_s, tflops_achieved)."""
    from artdeco_tpu_torch.models.mast3r import MASt3RConfig
    from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner

    dev = resolve(device)
    cfg = MASt3RConfig()
    log("building the full MASt3R (ViT-L, bf16 trunk, random weights)...")
    runner = Mast3rRunner.create(cfg, device=dev, seed=0)
    rng = np.random.RandomState(0)
    img_f = torch.as_tensor(rng.rand(1, 3, h, w).astype(np.float32) * 2 - 1, device=dev)
    img_k = torch.as_tensor(rng.rand(1, 3, h, w).astype(np.float32) * 2 - 1, device=dev)
    feat_k, pos_k = runner.encode_image(img_k)
    feat_f, pos_f = runner.encode_image(img_f)
    runner.decode(feat_f, pos_f, feat_k, pos_k, (h, w))
    sync(dev)

    def wall_s(fn):
        fn()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(dev)
        return (time.perf_counter() - t0) / iters

    encode = functools.partial(runner.encode_image, img_f)
    decode = functools.partial(runner.decode, feat_f, pos_f, feat_k, pos_k, (h, w))
    t_enc, t_dec = wall_s(encode), wall_s(decode)
    fl_enc, fl_dec = model_flops(runner, img_f, feat_f, pos_f, feat_k, pos_k, (h, w))
    tflops = (fl_enc + fl_dec) / max(t_enc + t_dec, 1e-9) / 1e12
    (dev_enc, ops_enc), (dev_dec, ops_dec) = (
        (device_busy_ms(encode, iters, dev), device_busy_ms(decode, iters, dev))
        if dev.type == "cuda" else ((float("nan"), 0.0),) * 2)
    log(f"mast3r model @ {w}x{h} [{card_label(str(dev))}]: encode {1e3 * t_enc:.2f} ms wall "
        f"({dev_enc:.2f} busy on the device, {ops_enc:.0f} device ops) + pair decode+heads "
        f"{1e3 * t_dec:.2f} ms wall ({dev_dec:.2f} busy on the device, {ops_dec:.0f} device "
        f"ops); {fl_enc / 1e9:.1f} + {fl_dec / 1e9:.1f} GFLOP (FlopCounterMode) -> "
        f"{tflops:.1f} TFLOP/s achieved")
    if record is not None:
        record.update(encode_ms=1e3 * t_enc, decode_ms=1e3 * t_dec, encode_device_ms=dev_enc,
                      decode_device_ms=dev_dec, encode_device_ops=ops_enc,
                      decode_device_ops=ops_dec, encode_gflop=fl_enc / 1e9,
                      decode_gflop=fl_dec / 1e9, model_tflops=tflops)
    return t_enc, t_dec, tflops


# ---------------------------------------------------------------------------
# 4. The oracle pipeline
# ---------------------------------------------------------------------------

def pipeline_args() -> types.SimpleNamespace:
    """``bench.py``'s arguments: a 512-pixel SLAM stream, the 20/10 schedule
    of record, no test frames."""
    return types.SimpleNamespace(
        source_path="", images_dir="images", downsampling=2.0,
        max_size_slam=512, start_at=0, end_at=0, seq_length=0,
        image_sampling=0, dataset_name="synthetic", test_hold=-1,
        calib=None, init_focal=-1.0, init_fov=-1.0, optimize_focal=False,
        covariance_filter=True, point_fusion_frontend=True,
        use_all_frames=False, use_same_set_of_keyframes=False,
        min_displacement=0.03, thres_keyframe=0.8, num_GBA=1,
        num_key_iterations=20, num_common_iterations=10,
        sh_degree=3, local_feat_dim=16, global_feat_dim=16, pyr_levels=2,
        accurate_loop_closure=False, model_size="tiny",
        retrieval_checkpoint_path="", pi3_checkpoint_path="",
        max_active_keyframes=400,
    )


def pipeline_mapper_config():
    """``bench.py``'s mapper sizes: room for the 64-frame stream's ~35k
    Gaussians and more without growing the slab mid-stream."""
    from artdeco_tpu_torch.mapper.config import MapperConfig

    return MapperConfig(
        capacity=1 << 18, initial_capacity=1 << 17, new_budget=1 << 14,
        cluster_capacity=1 << 13, voxel_table_size=1 << 16,
        vis_budget_init=1 << 15,
        keyframe_capacity=256, sh_degree=3, local_feat_dim=16,
        global_feat_dim=16, pyr_levels=2, gs_add_ratio=1.0,
        init_proba_scaler=4.0,
    )


def oracle_system(n_frames: int, width: int, height: int, mapper_cfg, device) -> tuple:
    """``bench.py``'s oracle set-up: a synthetic stream of ``n_frames`` at
    ``width`` x ``height`` with ``pipeline_args``, ``config/base.yaml``
    with ``match_frac_thresh`` 0.95, an ``OracleRunner`` holding every
    frame, and a ``System`` with ``mapper_cfg`` on ``device``.  Returns
    (system, dataset, runner, config)."""
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
    from artdeco_tpu_torch.models.oracle import OracleRunner
    from artdeco_tpu_torch.runtime.system import System
    from artdeco_tpu_torch.utils.config import load_config

    args = pipeline_args()
    dataset = SyntheticDataset(args, n_frames=n_frames, width=width, height=height)
    config = load_config(str(REPO / "config" / "base.yaml"))
    # with exact oracle matches, 0.95 yields a keyframe every ~4-6 frames at
    # this motion (4.1 px a frame at 512)
    config["tracking"]["match_frac_thresh"] = 0.95
    runner = OracleRunner((dataset.H_slam, dataset.W_slam), dataset.K_slam,
                          config["matching"], device=device)
    for i in range(len(dataset)):
        img, info = dataset[i]
        T = np.ones(8, np.float32)
        T[:7] = info["Twc_gt"]
        runner.register(dataset.transform.to_slam(img), i, T)
    system = System(args, config, dataset, runner, mapper_cfg=mapper_cfg, device=device)
    return system, dataset, runner, config


def _launches() -> dict:
    from artdeco_tpu_torch.ops import refine_dense as RD
    from artdeco_tpu_torch.ops.splat import composite as C

    return {"fwd": C.composite_fwd.launches, "bwd": C.composite_bwd.launches,
            "k3": RD.window_argmax.launches}


def keyframe_pose_errors(system, dataset) -> list:
    """Each keyframe's pose error against ground truth: the norm of the
    Sim(3) log of T_gt^-1 T_WC."""
    from artdeco_tpu_torch.geometry import lie

    errs = []
    for i in range(len(system.keyframes)):
        fid = int(system.keyframes.dataset_idx[i])
        Tgt = np.ones(8, np.float32)
        Tgt[:7] = dataset.Twc_gt[fid]
        d = lie.sim3_log(lie.sim3_mul(lie.sim3_inv(torch.as_tensor(Tgt)),
                                      torch.as_tensor(system.keyframes.T_WC[i])))
        errs.append(float(torch.linalg.vector_norm(d)))
    return errs


def bench_pipeline(n_frames: int = 64, width: int = 1024, height: int = 576, device=None,
                   record: dict = None) -> tuple:
    """The oracle pipeline, overlapped, at ``bench.py``'s settings
    (``pipeline_args``, ``config/base.yaml`` with ``match_frac_thresh``
    0.95, the mapper sizes of ``pipeline_mapper_config``, 12 warm-up
    frames).  Steady-state time is
    wall clock from the end of the warm-up (its mapper backlog drained and
    the device synchronised) to the worker's close with the device
    synchronised: every mapper burst the steady frames caused is inside.

    Returns (s_per_frame, n_gaussians, stage ms per frame {"track",
    "backend", "map"}, max/median tracking latency, keyframes, max keyframe
    pose error).  ``record``, where given, also gets the keyframe count
    after each frame, the kernels' launches over the stream with the calls
    that launch them, and the steady window's start and end (``time.time``)."""
    from artdeco_tpu_torch import kernels
    from artdeco_tpu_torch.runtime.system import _MapperWorker, _UploadAhead

    dev = resolve(device)
    system, dataset, runner, _ = oracle_system(n_frames, width, height,
                                               pipeline_mapper_config(), dev)
    log(f"pipeline: slam {dataset.W_slam}x{dataset.H_slam}, map {dataset.W_map}x"
        f"{dataset.H_map}, {n_frames} frames [{card_label(str(dev))}]")
    # in place of bench.py's prewarm drain: the kernels are built and loaded
    # before the clock starts
    if dev.type == "cuda":
        kernels.load()
    sync(dev)

    t_start = time.time()
    per_frame = []          # main-thread (tracking-latency) per-frame time
    stage = {"track": 0.0, "backend": 0.0}
    kf_after = []
    before = _launches()
    worker = _MapperWorker(system)
    t_warm_end = None
    # SLAM uploads one frame ahead, off the tracking thread, as System.run
    frames = iter(_UploadAhead((dataset[i] for i in range(n_frames)), dataset.transform,
                               dev, runner=runner))
    for i in range(n_frames):
        t0 = time.time()
        img, info = next(frames)
        msg = system.frontend.process_frame(img, info)
        t1 = time.time()
        t2 = t1
        if msg is not None:
            work = system.backend.process_sync(msg)
            t2 = time.time()
            if work is not None:
                worker.submit(work)
        t3 = time.time()
        system.n_frames += 1
        dt = t3 - t0
        if i == WARM_FRAMES - 1:
            # drain the warm-up backlog, on the host and then on the device,
            # so its mapper work cannot leak into the steady window
            worker.q.join()
            sync(dev)
            t_warm_end = time.time()
        if i >= WARM_FRAMES:
            per_frame.append(dt)
            stage["track"] += t1 - t0
            stage["backend"] += t2 - t1
        kf_after.append(len(system.keyframes))
        log(f"  frame {i}: {1000 * dt:.0f} ms (trk {1000 * (t1 - t0):.0f} bkd-sync "
            f"{1000 * (t2 - t1):.0f}), kf={len(system.keyframes)}")
    worker.close()
    # the worker's queue is empty when the host ends its last item: wait
    # for the device too
    sync(dev)
    t_end = time.time()
    after = _launches()
    n_gauss = int(system.scene_model.n_active_gaussians)
    nsteady = max(len(per_frame), 1)
    if t_warm_end is None:   # n_frames <= WARM_FRAMES: no steady window, use all
        t_warm_end, nsteady, per_frame = t_start, max(n_frames, 1), [0.0]
    t_pipe = (t_end - t_warm_end) / nsteady   # wall incl. worker drain
    med = float(np.median(per_frame))
    mx = float(np.max(per_frame))
    stages_ms = {k: 1000 * v / nsteady for k, v in stage.items()}
    stages_ms["map"] = max(0.0, 1000 * t_pipe - stages_ms["track"] - stages_ms["backend"])
    n_kf = len(system.keyframes)
    log(f"pipeline steady-state [{card_label(str(dev))}]: {1000 * t_pipe:.1f} ms/frame wall "
        f"(main-thread track {stages_ms['track']:.0f} / backend-sync "
        f"{stages_ms['backend']:.0f} / overlapped mapper+drain {stages_ms['map']:.0f}), "
        f"{n_gauss} gaussians, {n_kf} keyframes, total {t_end - t_start:.0f}s")
    log(f"tracking-latency median {1000 * med:.0f} ms / max {1000 * mx:.0f} ms "
        f"(max/median {mx / max(med, 1e-9):.1f}x)")
    for label, src in (("tracker", system.frontend.tracker.timers),
                       ("backend", system.backend.timers),
                       ("factor-graph", system.backend.factor_graph.timers)):
        parts = [f"{k} {1000 * v[0] / max(v[1], 1):.0f}ms x{v[1]}"
                 for k, v in sorted(src.items())]
        if parts:
            log(f"  {label}: " + ", ".join(parts))
    # trajectory sanity: keyframe poses must track ground truth (the speed
    # number is meaningless if the pipeline silently diverges)
    errs = keyframe_pose_errors(system, dataset)
    max_err = max(errs)
    log(f"keyframe pose error vs GT: max {max_err:.4f} "
        f"({'OK' if max_err < POSE_ERR_MAX else 'DIVERGED'})")
    if record is not None:
        sm, fe, bk = system.scene_model, system.frontend, system.backend
        record.update(
            pipeline_ms=1e3 * t_pipe, stages_ms=stages_ms, n_gaussians=n_gauss,
            keyframes=n_kf, keyframe_frames=system.keyframes.dataset_idx[:n_kf].tolist(),
            kf_after_frame=kf_after, max_pose_err=max_err, latency_median_ms=1e3 * med,
            latency_max_ms=1e3 * mx, steady_window=[t_warm_end, t_end],
            launches={k: after[k] - before[k] for k in after},
            calls={"steps": sm.n_train_steps, "renders": sm.n_renders,
                   "tracked": fe.tracker.timers.get("trk.match", [0.0, 0])[1],
                   "match_rows": bk.factor_graph.match_rows,
                   "pair_matches": bk.pair_matches})
    return t_pipe, n_gauss, stages_ms, mx / max(med, 1e-9), n_kf, max_err


def main() -> int:
    dev = resolve(None)
    # no released checkpoint is in the repository: the model is timed on
    # random weights (the same FLOPs and layout) and the pipeline runs the
    # exact-geometry oracle; the port's parity with the JAX package is held
    # by tests/test_torch_*.py
    log("checkpoints: no released weights in the repository; the model runs on "
        "seeded random weights, the pipeline on the oracle")
    summary = {"device": card_label(str(dev))}
    summary["golden"] = golden_check(dev)
    sol = device_speed_of_light(device=dev, record=summary)
    t_enc, t_dec, tflops = bench_model(device=dev, record=summary)
    log(f"model MFU vs measured device ceiling: {100 * tflops / max(sol, 1e-9):.1f}% "
        f"({tflops:.1f} of {sol:.1f} TFLOP/s achievable; {100 * tflops / PEAK_BF16_TFLOPS:.2f}% "
        f"of the published {PEAK_BF16_TFLOPS:.0f}) [{card_label(str(dev))}]")
    t_pipe, n_gauss, stages_ms, spike, n_kf, max_err = bench_pipeline(device=dev,
                                                                      record=summary)
    # no overlap: the pipeline's oracle already runs the whole matching
    # cascade in place of the model, so only encode + decode+heads are added
    fps = 1.0 / (t_pipe + t_enc + t_dec)
    summary["fps"] = fps
    log("bench summary: " + json.dumps(summary))
    if max_err >= POSE_ERR_MAX:
        raise SystemExit(f"pipeline diverged: keyframe pose error {max_err:.4f} >= "
                         f"{POSE_ERR_MAX}")
    print(json.dumps({
        "metric": "end_to_end_fps",
        "value": round(fps, 2),
        "unit": ("frames/s; stage ms/frame: "
                 f"model-encode {1000 * t_enc:.0f} + model-decode "
                 f"{1000 * t_dec:.0f} ({tflops:.0f} TFLOP/s = "
                 f"{100 * tflops / max(sol, 1e-9):.0f}% of the device's "
                 f"measured {sol:.0f} TFLOP/s matmul ceiling) + track(incl "
                 f"cascade) {stages_ms['track']:.0f} + backend "
                 f"{stages_ms['backend']:.0f} + map {stages_ms['map']:.0f}; "
                 f"512-res slam, 20/10 schedule, {n_gauss} gaussians, "
                 f"frame-max/median {spike:.1f}x"),
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
