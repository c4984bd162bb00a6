#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at full width and checks them: the
online mapper (``MapperStage``) over a 16-frame 512x384 synthetic plane
stream at the ``MapperConfig`` defaults, and the tracking frontend
(``Frontend`` + ``OracleRunner``) over a 120-frame 512x384 stream with
``config/base.yaml`` as it is.

1. device: a CUDA device is required; prints ``nvidia-smi``'s name and
   power limit; builds the CUDA kernels from ``artdeco_tpu_torch/csrc``
   and prints ptxas's register counts and the launch shapes of K1 and K3
   (blocks, threads, cluster size, registers, blocks an SM holds).
2. kernel goldens: the tile compositor's kernels (K1 forward, K2 backward)
   against their plain PyTorch versions on a small random case.
3. the mapper slice: every second frame is important (densify + 20
   iterations), the others common (10 iterations), frame 8 is a held-out
   test frame.  The kernels' launch counters must show the stream went
   through them, the loss must stay finite, the first keyframe's PSNR
   must rise by at least 3 dB after its densify, and the test-frame PSNR
   must be finite.
4. kernel goldens and timings at the training shape (256x192, 192 tiles):
   on the slot data of the largest scene of the stream, and on a random
   scene of 10^5 Gaussians, the size of a real scene.  K1's stop chunks
   must equal the plain version's on every tile; K2 runs on them; two K2
   calls must be bitwise equal.  Each time is printed beside
   the kernel's bound (the least time the card could take for the work
   these inputs need, counted from the plain version's alpha) and the
   share of the bound it reaches; K2's kernels are also timed one by one
   under torch.profiler.
5. profile: one more 20-iteration burst under torch.profiler; prints the
   window, the device's busy time and idle share, the kernel count, the
   kernels that take the most device time, and the peak device memory.
6. K3 goldens and timings: the refine window-argmax kernel against its
   plain version on a small random case and at the stream's shape
   (384x512, 24 channels, radius 4, dilation 5, the oracle's descriptors
   and the matcher's own initial positions and validity), positions and
   scores bitwise equal; times both and prints K3's bound.
7. the tracking slice: 120 frames, 4.1 px of motion each; K3's launches
   must equal the matches made, no frame may be lost, at least two
   keyframes, ATE RMSE < 0.03 m against ground truth; prints ms per
   tracked frame, the split between matching and ``track_step``, and a
   profile of a few tracked frames.

Prints one line per phase, then a JSON line of the kernels and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is then not 0 and the last line is not printed.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
WIDTH, HEIGHT, N_FRAMES, TEST_HOLD = 512, 384, 16, 8
KEY_ITERS, COMMON_ITERS = 20, 10
N_TIMED = 20
HOLD_CYCLES = 2_000_000  # about 1 ms of the SM clock: longer than a call's enqueue
N_BIG = 100_000    # Gaussians of the realistic-size golden
N_PROFILED = 20    # iterations of the profiled burst
TRACK_W, TRACK_H, TRACK_FRAMES = 512, 384, 120
K3_RADIUS, K3_DILATION = 4, 5
N_PROFILED_FRAMES = 5

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense; at a 700 W
# limit): float32 outside the tensor cores, bf16 on the tensor cores (f32
# accumulation), and HBM3.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# flops per (pixel, slot) pair, counted from csrc/composite.cu.  Alpha, on
# every pair of a real (non-padding) slot: dx, dy, sigma (9), exp (2), raw
# (1) = 14.  The rest only where alpha > 0 (elsewhere every term is 0):
# K1: w, 7 FMAs (14), T *= 1 - a (2).  K2 pass A: cg (7 FMAs), w,
# q += w cg (2), T (2).  K2 pass B: cg (14), w, pref_q (2), suffix, dl_da
# (5), g_sigma, the mean, conic and opacity terms (4 + 4 + 3 + 2 + 3 + 1),
# w gc (7), T (2), and one add per pixel for each of the 13 sums over the
# tile's pixels.
FLOP_ALPHA = 14
FLOP_K1 = 1 + 14 + 2
FLOP_K2_A = 14 + 1 + 2 + 2
FLOP_K2_B = 14 + 1 + 2 + 1 + 5 + 1 + 17 + 7 + 2 + 13
K3_WINDOW = 5 * 9 * 9         # window positions: dilations 5..1, 9x9 each


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, n=N_TIMED):
    """Median over n runs of one call's time on the device, timed with CUDA
    events (after two warm-up calls).  Before each call a device-side sleep
    (``HOLD_CYCLES``) holds the stream while the host enqueues the events
    and the call, so the events bracket the call's work on the device and
    not the host's launch overhead, which sets the time of a call as short
    as K1's.  A call that waits on the device (the plain versions sync the
    host) still includes the host time after the wait."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def random_slots(device, seed=1, n=300, width=64, height=48):
    """Slot data of a random Gaussian scene (SH degree 3, depths 1.5-3),
    packed as the renderer packs it.  Its footprints give about 7.8
    (tile, Gaussian) pairs per Gaussian at 256x192, as the mapper's scenes
    on the card do (5-8)."""
    import torch
    from artdeco_tpu_torch.ops.splat import api

    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    means = torch.stack([u(n) * 2 - 1, (u(n) * 2 - 1) * 0.7, 1.5 + 1.5 * u(n)], -1)
    quats = torch.randn(n, 4, generator=g)
    scales = torch.exp(-4 + 1.5 * u(n, 3))
    opac = 0.2 + 0.75 * u(n)
    colors = torch.randn(n, 16, 3, generator=g) * 0.3
    K = torch.tensor([[0.9 * width, 0, width / 2], [0, 0.9 * width, height / 2],
                      [0, 0, 1.0]])
    args = [x.to(device) for x in (means, quats, scales, opac, colors, torch.eye(4), K)]
    with torch.no_grad():
        return api.pack_slots(*args, width, height, sh_degree=3, eps2d=0.01)


def bound(flops: float, nbytes: float, peak: float = PEAK_F32) -> tuple:
    """(ms, "operations" or "bytes"): the least time for ``flops``
    operations at ``peak`` per second and ``nbytes`` of device memory
    traffic on an H100."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def composite_work(p, stop) -> dict:
    """What the compositor's work on packed slots ``p`` needs, counted from
    the plain version's alpha: the real slots of the runs (padding slots are
    zero), their (pixel, slot) pairs and those with alpha > 0, each in all
    and before each tile's stop chunk ``stop``."""
    import torch
    from artdeco_tpu_torch.ops.splat import composite as C

    T = p.tiles_x * p.tiles_y
    px, py = C._pix_coords(T, p.tiles_x, p.slot_data.device)
    nchunks = p.pad_counts.long() // C.CHUNK
    keys = ("slots", "slots_voted", "hit", "hit_voted")
    n = {k: torch.zeros((), dtype=torch.int64, device=p.slot_data.device) for k in keys}
    with torch.no_grad():
        for ci in range(int(nchunks.max()) if T else 0):
            has = ci < nchunks
            d, _ = C._gather_chunk(p.slot_data, p.pad_starts, ci, has)
            real = (d[5] != 0) & has[:, None]                        # (T, CHUNK)
            hit = (C._chunk_alpha(d, px, py)[0] > 0) & real[:, None, :]
            voted = (ci < stop.long())[:, None]
            n["slots"] += real.sum()
            n["slots_voted"] += (real & voted).sum()
            n["hit"] += hit.sum()
            n["hit_voted"] += (hit & voted[:, :, None]).sum()
    return {k: int(v) for k, v in n.items()}


def composite_bounds(p, stop):
    """K1's and K2's bounds on packed slots ``p`` with K1's stop chunks, and
    the work counts they rest on.  K1 and K2's pass A composite the real
    slots up to each tile's stop chunk, pass B every real slot of every run;
    each computes alpha on every (pixel, real slot) pair and the rest only
    where alpha > 0.  Bytes: each input read once (the real slots the work
    needs, the image gradient), each output written once (the images and
    stop chunks; the real slots' gradients)."""
    n = composite_work(p, stop)
    T = p.tiles_x * p.tiles_y
    img = 4 * T * 256 * 8
    k1 = bound(256 * FLOP_ALPHA * n["slots_voted"] + FLOP_K1 * n["hit_voted"],
               64 * n["slots_voted"] + img + 4 * T)
    k2 = bound(256 * FLOP_ALPHA * (n["slots_voted"] + n["slots"])
               + FLOP_K2_A * n["hit_voted"] + FLOP_K2_B * n["hit"],
               128 * n["slots"] + img + 4 * T)
    return k1, k2, n


def kernel_split(fn, n=10) -> str:
    """Device ms per call of each kernel that ``fn`` launches
    (torch.profiler over n calls, after one warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    # "void ns::name<...>(...)" -> "name"
    names = [re.split(r"[<(]", e.key.replace("(anonymous namespace)::", "")
                      .removeprefix("void "))[0].split("::")[-1] for e in dev]
    return ", ".join(f"{name} {e.self_device_time_total / 1e3 / n:.4f}"
                     for name, e in zip(names, dev)) or "not measured"


def launch_shape(info: dict, blocks: int, shape: str) -> str:
    """One kernel's launch shape (``kernels.launch_info``) and its blocks at
    ``shape``, as phase 1 prints it."""
    n = blocks * info["cluster"]
    return (f"{n} blocks at {shape} of {info['threads']} threads, cluster "
            f"{info['cluster']}, {info['registers']} registers, {info['spill_bytes']} B "
            f"spilled, {info['shared_bytes']} B shared, {info['blocks_per_sm']} blocks per "
            f"SM, {info['max_clusters']} clusters on the card at once")


def train_view_slots(sm, cfg, kf_id):
    """The slot data of a training render of keyframe ``kf_id`` of the scene
    model ``sm`` (at the coarsest pyramid level of ``cfg``)."""
    import torch
    from artdeco_tpu_torch.mapper.keyframe import get_Rt
    from artdeco_tpu_torch.mapper.scene_model import effective_params
    from artdeco_tpu_torch.ops.splat import api

    lvl = cfg.pyr_levels - 1
    with torch.no_grad():
        slab = sm.slab.prefix(sm._train_len)
        viewmat = get_Rt(sm.pool, kf_id)
        sel, opac, scale, rot, colors = effective_params(
            slab, sm.gfeat.val, sm.mlp, viewmat, cfg.cluster_capacity)
        return api.pack_slots(slab.xyz, rot, scale, opac, colors, viewmat,
                              sm._K_at_lvl(lvl), WIDTH >> lvl, HEIGHT >> lvl,
                              sh_degree=cfg.sh_degree, eps2d=cfg.low_pass_filter_eps,
                              valid_mask=sel)


def golden(p, timed: bool):
    """K1/K2 against their plain versions on packed slots ``p``.

    Tolerances: the kernel multiplies transmittance along (T *= 1 - a), the
    plain version sums logs and exponentiates, so forward RGB and alpha
    agree to 1e-4 absolute and depth to 1e-3 relative.  The backward sums
    each slot's gradient over 256 pixels in a fixed shuffle tree, the plain
    version in matmul order: 1e-3 relative to each gradient group's largest
    entry.  K2 and its plain version both take K1's stop chunks; two K2
    calls must be bitwise equal.  The renderer's gather VJP (no atomics,
    fixed order) is not part of this comparison."""
    import torch
    from artdeco_tpu_torch.ops.splat import composite as C

    args = (p.slot_data.contiguous(), p.pad_starts, p.pad_counts, p.tiles_x, p.tiles_y)
    out, stop = C.composite_fwd(*args)
    ref, stop_ref = C.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    rgba = [0, 1, 2, C.C_MAX - 1]
    err_rgba = (out[..., rgba] - ref[..., rgba]).abs().max().item()
    d, dr = out[..., 3], ref[..., 3]
    depth_ok = bool(((d - dr).abs() <= 1e-3 * dr.abs() + 1e-5).all())
    check(err_rgba <= 1e-4, f"K1 RGB/alpha max abs err {err_rgba} > 1e-4")
    check(depth_ok, "K1 depth beyond 1e-3 relative")
    fwd_err = (out - ref).abs().max().item()

    g_out = torch.randn(out.shape, generator=torch.Generator(device=out.device)
                        .manual_seed(7), device=out.device)
    gk = C.composite_bwd(*args, g_out, stop)
    gk2 = C.composite_bwd(*args, g_out, stop)
    gp = C.composite_bwd_plain(*args, g_out, stop)
    torch.cuda.synchronize()
    check(torch.equal(gk, gk2), "K2: two calls on the same inputs differ")
    for rows, name in (([0, 1], "mean2d"), ([2, 3, 4], "conic"), ([5], "opacity"),
                       (list(range(8, 16)), "channels")):
        e = (gk[rows] - gp[rows]).abs().max().item()
        s = gp[rows].abs().max().item()
        check(e <= 1e-3 * max(s, 1e-12), f"K2 {name} err {e} > 1e-3 * {s}")
    bwd_err = (gk - gp).abs().max().item()
    (k1_bound, k1_by), (k2_bound, k2_by), work = composite_bounds(p, stop)
    res = dict(fwd_err=fwd_err, bwd_err=bwd_err, fwd_bound=k1_bound, fwd_by=k1_by,
               bwd_bound=k2_bound, bwd_by=k2_by, chunks=int(p.pad_counts.sum()) // 128,
               stop_chunks=int(stop.sum()), work=work,
               stop_equal=int((stop == stop_ref).sum()), tiles=stop.numel())
    check(res["stop_equal"] == res["tiles"],
          f"K1 stop chunks equal the plain version's on {res['stop_equal']}/{res['tiles']} tiles")
    if timed:
        res.update(
            fwd_ms=cuda_ms(lambda: C.composite_fwd(*args)),
            fwd_plain_ms=cuda_ms(lambda: C.composite_fwd_plain(*args)),
            bwd_ms=cuda_ms(lambda: C.composite_bwd(*args, g_out, stop)),
            bwd_plain_ms=cuda_ms(lambda: C.composite_bwd_plain(*args, g_out, stop)),
            bwd_kernels=kernel_split(lambda: C.composite_bwd(*args, g_out, stop)),
        )
    return res


def profile_window(fn, n_steps: int, what: str) -> str:
    """``fn()`` (``n_steps`` steps of ``what``) under torch.profiler: the
    window (host clock), the device's busy time (sum of its kernels,
    memcpys and memsets, one stream) and idle share, the count of device
    kernels, the kernels with the most device time, and the peak device
    memory.  The profiler adds host time to every launch, so the window is
    longer than the same work unprofiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    kernels = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    tops = "; ".join(f"{e.key[:48]} {100 * e.self_device_time_total / 1e3 / busy_ms:.1f}% "
                     f"x{e.count}" for e in top) if busy_ms > 0 else "not measured"
    idle = f"{1 - busy_ms / window_ms:.3f}" if busy_ms > 0 else "not measured"
    return (f"{n_steps} {what}, window {window_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms, idle share {idle}, {kernels} device kernels "
            f"({kernels / n_steps:.0f}/{what.rstrip('s')}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; top: {tops}")


def k3_stream_inputs(runner, h: int, w: int, mcfg: dict) -> tuple:
    """K3's inputs on the first tracked frame of the tracking stream: frame
    1 against keyframe 0 of ``runner`` (an ``OracleRunner`` with both
    registered), the matcher's own starting positions and validity.
    Returns (D11 (h, w, 24) bf16, D21 (h*w, 24) bf16, p (h*w, 2) int32,
    valid (h*w,) bool)."""
    import torch
    from artdeco_tpu_torch.ops import matching as M

    X11 = runner._dev(1)[0].reshape(1, h, w, 3)
    X21 = runner._cross_dev(0, 1).reshape(1, h, w, 3)
    p1, valid = M.project_matches(X11, X21, None, max_iter=int(mcfg["max_iter"]),
                                  lambda_init=float(mcfg["lambda_init"]),
                                  cost_thresh=float(mcfg["convergence_thresh"]),
                                  dist_thresh=float(mcfg["dist_thresh"]))
    return (runner._dev(1)[1].reshape(h, w, -1).to(torch.bfloat16),
            runner._dev(0)[1].to(torch.bfloat16), p1[0].contiguous(), valid[0])


def k3_golden(D11b, D21b, p, valid, timed: bool):
    """K3 against its plain version: positions and scores bitwise equal on
    every query (both add the exact bf16 products in channel order, K3 with
    FMAs).  Returns the share of equal positions, the max score difference
    and, if timed, both times (CUDA events, median of 20)."""
    import torch
    from artdeco_tpu_torch.ops import refine_dense as RD

    args = (D11b, D21b, p, valid, K3_RADIUS, K3_DILATION)
    pk, sk = RD.window_argmax(*args)
    pp, sp = RD.window_argmax_plain(*args, 1, RD.FLT_MIN)
    torch.cuda.synchronize()
    same = 1.0 - (pk != pp).any(-1).float().mean().item()
    err = (sk - sp).abs().max().item()
    check(torch.equal(pk, pp), f"K3 positions equal on {same:.6f} of the queries, not all")
    check(torch.equal(sk.view(torch.int32), sp.view(torch.int32)),
          f"K3 scores not bitwise equal (max difference {err:.3g})")
    res = dict(same=same, err=err, n=p.shape[0], n_valid=int(valid.sum()))
    if timed:
        res.update(ms=cuda_ms(lambda: RD.window_argmax(*args)),
                   plain_ms=cuda_ms(lambda: RD.window_argmax_plain(*args, 1, RD.FLT_MIN)))
    return res


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import torch
        from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
        from artdeco_tpu_torch.mapper.config import MapperConfig
        from artdeco_tpu_torch import kernels
        from artdeco_tpu_torch.device import require_cuda
        from artdeco_tpu_torch.mapper import losses
        from artdeco_tpu_torch.ops.splat import composite as C
        from artdeco_tpu_torch.runtime.system import MapperStage, exact_mapper_messages
        from artdeco_tpu_torch.eval.trajectory import evaluate_trajectory
        from artdeco_tpu_torch.models.oracle import OracleRunner
        from artdeco_tpu_torch.ops import refine_dense as RD
        from artdeco_tpu_torch.utils.config import load_config
        from artdeco_tpu_torch.vslam.frontend import Frontend
        from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
    except ImportError as e:
        print(f"chip_smoke: needs the repository's packages and torch: {e}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # -- 1. device -----------------------------------------------------------
    dev = require_cuda()
    # float32 references: no TF32 in matmuls or cuDNN convolutions (SSIM)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    lib_path, log = kernels.build()
    kernels.load()
    build_s = time.time() - t0
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; kernels built in {build_s:.1f} s "
          f"({os.path.basename(lib_path)}; {'; '.join(regs)})", flush=True)
    lvl = MapperConfig().pyr_levels - 1
    tiles = -(-(WIDTH >> lvl) // 16) * -(-(HEIGHT >> lvl) // 16)
    k1_shape = launch_shape(kernels.launch_info("artdeco_composite_fwd_info"), tiles,
                            f"{WIDTH >> lvl}x{HEIGHT >> lvl}")
    k3_shape = launch_shape(kernels.launch_info("artdeco_refine_info", K3_RADIUS),
                            -(-TRACK_W * TRACK_H // 256), f"{TRACK_W}x{TRACK_H}")
    print(f"phase 1 launch shapes: K1 {k1_shape}; K3 r{K3_RADIUS} {k3_shape}", flush=True)

    # -- 2. kernel goldens, small random case ------------------------------
    small = golden(random_slots(dev), timed=False)
    print(f"phase 2 goldens (random 64x48): K1 max abs err {small['fwd_err']:.3g}, "
          f"K2 max abs err {small['bwd_err']:.3g}", flush=True)

    # -- 3. the slice --------------------------------------------------------
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=TEST_HOLD, max_size_slam=WIDTH),
                          n_frames=N_FRAMES, width=WIDTH, height=HEIGHT)
    check((ds.W_map, ds.H_map) == (WIDTH, HEIGHT), "map resolution")
    cfg = MapperConfig()
    stage = MapperStage(ds, cfg, device=dev, seed=SEED, num_key_iterations=KEY_ITERS,
                        num_common_iterations=COMMON_ITERS)
    sm = stage.scene_model
    lvl = cfg.pyr_levels - 1

    def psnr_of(kf_id):
        img = sm.render_from_id(kf_id)["render"]
        return float(losses.psnr(img, sm.keyframes[kf_id].image_pyr[0]))

    C.composite_fwd.launches = 0
    C.composite_bwd.launches = 0
    n_iters = n_renders = 0
    burst_s, frame_s = [], []
    losses_seen = []
    biggest = (0, None)
    psnr0_start = None
    torch.cuda.synchronize()
    t_stream = time.time()
    for m in exact_mapper_messages(ds, important_every=2):
        t0 = time.time()
        had_scene = sm._has_gaussians
        stage.ingest(m)
        if m["is_important"] and not m["is_test"]:
            n_renders += int(had_scene)  # the densify penalty render
        if m["frame_id"] == 0:
            psnr0_start = psnr_of(0)
            n_renders += 1
        torch.cuda.synchronize()
        t1 = time.time()
        out = stage.train(m)
        torch.cuda.synchronize()
        t2 = time.time()
        iters = KEY_ITERS if m["is_important"] else COMMON_ITERS
        n_iters += iters
        burst_s.append((t2 - t1, iters))
        frame_s.append(t2 - t0)
        check("loss" in out, f"frame {m['frame_id']} trained no burst")
        losses_seen.append(float(out["loss"]))
        if sm.n_active_gaussians > biggest[0]:
            biggest = (sm.n_active_gaussians,
                       train_view_slots(sm, cfg, len(sm.keyframes) - 1))
    stream_s = time.time() - t_stream
    psnr0_end = psnr_of(0)
    n_renders += 1
    ev = stage.metrics()
    n_renders += ev["metrics"].get("n_test_frames", 0)
    launches = {"fwd": C.composite_fwd.launches, "bwd": C.composite_bwd.launches}

    check(launches["bwd"] == n_iters, f"K2 launches {launches['bwd']} != {n_iters} iterations")
    check(launches["fwd"] >= n_iters + n_renders,
          f"K1 launches {launches['fwd']} < {n_iters} iterations + {n_renders} renders")
    check(all(np.isfinite(losses_seen)), f"non-finite loss {losses_seen}")
    check(psnr0_end - psnr0_start >= 3.0,
          f"first keyframe PSNR {psnr0_start:.2f} -> {psnr0_end:.2f} dB, < +3 dB")
    test_psnr = ev["metrics"].get("PSNR", float("nan"))
    check(ev["metrics"].get("n_test_frames", 0) >= 1 and np.isfinite(test_psnr),
          f"test-frame PSNR {test_psnr}")
    ms_iter = 1e3 * sum(s for s, _ in burst_s) / sum(i for _, i in burst_s)
    print(f"phase 3 slice: {N_FRAMES} frames {WIDTH}x{HEIGHT}, {n_iters} iterations at "
          f"{WIDTH >> lvl}x{HEIGHT >> lvl}; launches K1 {launches['fwd']} K2 "
          f"{launches['bwd']}; loss {losses_seen[0]:.4f} -> {losses_seen[-1]:.4f}; "
          f"keyframe-0 PSNR {psnr0_start:.2f} -> {psnr0_end:.2f} dB; test PSNR "
          f"{test_psnr:.2f} dB SSIM {ev['metrics']['SSIM']:.4f}; active Gaussians "
          f"{ev['n_gaussians']} (peak {biggest[0]}); {ms_iter:.2f} ms/iteration, "
          f"{1e3 * statistics.mean(frame_s):.1f} ms/keyframe, stream {stream_s:.1f} s",
          flush=True)

    # -- 4. kernel goldens + timings at the training shape -----------------
    def golden_line(what, p, n_gauss):
        r = golden(p, timed=True)
        w = r["work"]
        print(f"phase 4 goldens, {what} ({p.width}x{p.height}, {p.slot_data.shape[1]} "
              f"slots, {int(p.meta.num_pairs)} pairs, {n_gauss} Gaussians, {r['chunks']} "
              f"chunks in runs, {r['stop_chunks']} before the vote; K1 stop chunks equal "
              f"the plain version's on {r['stop_equal']}/{r['tiles']} tiles; real slots "
              f"{w['slots']} ({w['slots_voted']} before the vote), pixel-slot pairs with "
              f"alpha > 0 {w['hit']} ({w['hit_voted']} before the vote) of "
              f"{256 * w['slots']}): K1 err {r['fwd_err']:.3g} {r['fwd_ms']:.4f} ms (bound "
              f"{r['fwd_bound']:.4f} ms by {r['fwd_by']}, {r['fwd_bound'] / r['fwd_ms']:.1%} "
              f"of it; plain {r['fwd_plain_ms']:.3f} ms); K2 err {r['bwd_err']:.3g}, two "
              f"calls bitwise equal, {r['bwd_ms']:.4f} ms (bound {r['bwd_bound']:.4f} ms by "
              f"{r['bwd_by']}, {r['bwd_bound'] / r['bwd_ms']:.1%} of it; plain "
              f"{r['bwd_plain_ms']:.3f} ms; its kernels, device ms per call: "
              f"{r['bwd_kernels']})", flush=True)
        return r

    p = biggest[1]
    check((p.width, p.height) == (WIDTH >> lvl, HEIGHT >> lvl), "training shape")
    big = golden_line("stream scene", p, biggest[0])
    del p, biggest
    golden_line("random scene", random_slots(dev, seed=2, n=N_BIG, width=WIDTH >> lvl,
                                             height=HEIGHT >> lvl), N_BIG)

    # -- 5. profile of a training burst ----------------------------------
    print(f"phase 5 profile: "
          f"{profile_window(lambda: sm.optimization_loop(N_PROFILED, True), N_PROFILED, 'iterations')}",
          flush=True)

    # -- 6. K3 goldens + timings ---------------------------------------------
    tds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=TRACK_W),
                           n_frames=TRACK_FRAMES, width=TRACK_W, height=TRACK_H)
    check((tds.W_slam, tds.H_slam) == (TRACK_W, TRACK_H), "SLAM resolution")
    tcfg = load_config(os.path.join(ROOT, "config", "base.yaml"))
    mcfg = tcfg["matching"]
    check((mcfg["radius"], mcfg["dilation_max"]) == (K3_RADIUS, K3_DILATION), "matching config")
    runner = OracleRunner((tds.H_slam, tds.W_slam), tds.K_slam, mcfg, device=dev)
    t0 = time.time()
    for i in range(len(tds)):
        T = np.ones(8, np.float32)
        T[:7] = tds.Twc_gt[i]
        runner.register(tds.transform.to_slam(tds[i][0]), i, T)
    reg_s = time.time() - t0

    g = torch.Generator().manual_seed(SEED)
    n_small, hs, ws = 48 * 64, 48, 64
    small_k3 = k3_golden(torch.randn(hs, ws, 24, generator=g).to(dev, torch.bfloat16),
                         torch.randn(n_small, 24, generator=g).to(dev, torch.bfloat16),
                         torch.stack([torch.randint(0, ws, (n_small,), generator=g),
                                      torch.randint(0, hs, (n_small,), generator=g)], -1)
                         .to(dev, torch.int32),
                         (torch.rand(n_small, generator=g) > 0.2).to(dev), timed=False)
    h, w = tds.H_slam, tds.W_slam
    D11b, D21b, p1, valid = k3_stream_inputs(runner, h, w, mcfg)
    k3 = k3_golden(D11b, D21b, p1, valid, timed=True)
    # K3's bound: a 2-flop multiply-add of two bf16 values per channel at
    # every window position of every valid query, at the bf16 tensor-core
    # rate (f32 accumulation); the descriptors, positions and validity read
    # once, positions and scores written once
    nq, nf = k3["n"], D11b.shape[-1]
    k3_bound, k3_by = bound(2 * nf * K3_WINDOW * k3["n_valid"],
                            2 * h * w * nf + 2 * nq * nf + 8 * nq + nq + 8 * nq + 4 * nq,
                            PEAK_BF16)
    print(f"phase 6 K3 goldens: random 48x64 positions equal {small_k3['same']:.6f}, max "
          f"score err {small_k3['err']:.3g}; stream shape {h}x{w} f24 r{K3_RADIUS} "
          f"d{K3_DILATION} ({k3['n_valid']}/{k3['n']} valid queries) positions equal "
          f"{k3['same']:.6f}, max score err {k3['err']:.3g}, K3 {k3['ms']:.4f} ms "
          f"(bound {k3_bound:.4f} ms by {k3_by}, {k3_bound / k3['ms']:.1%} of it; plain "
          f"{k3['plain_ms']:.3f} ms)", flush=True)

    # -- 7. the tracking slice -------------------------------------------------
    store = KeyframeStore(h, w, tds.K_slam, buffer=64, device=dev)
    fe = Frontend(types.SimpleNamespace(), tcfg, tds, store, runner, device=dev)
    fe.tracker.sync_timing = True       # the match/step split below is device time
    frames = [tds[i] for i in range(len(tds))]
    torch.cuda.synchronize()
    RD.window_argmax.launches = 0
    frame_ms = []
    for img, info in frames:
        t0 = time.perf_counter()
        fe.process_frame(img, info)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    k3_launches = RD.window_argmax.launches
    n_kf = len(store)
    est, gt = fe.estimated_trajectory(), np.asarray(fe.frames_Twc_gt)
    ate = evaluate_trajectory("", "unused.json", est, gt, max_dt=0.05)["APE"]["rmse"]
    check(k3_launches == len(frames) - 1, f"K3 launches {k3_launches} != "
          f"{len(frames) - 1} matches")
    check(fe.lost_number == 0, f"{fe.lost_number} frames lost")
    check(n_kf >= 2, f"{n_kf} keyframes")
    check(ate < 0.03, f"ATE RMSE {ate} m")
    check(runner.d2h_lookups == 0, f"{runner.d2h_lookups} frame lookups pulled an image")
    tm = {k: 1e3 * v[0] / max(v[1], 1) for k, v in fe.tracker.timers.items()}
    print(f"phase 7 tracking slice: {len(frames)} frames {w}x{h} (oracle registered in "
          f"{reg_s:.1f} s); K3 launches {k3_launches}; lost {fe.lost_number}; keyframes "
          f"{n_kf} at frames {store.dataset_idx[:n_kf].tolist()}; ATE RMSE {ate:.5f} m over "
          f"{len(est)} frames; {statistics.median(frame_ms[1:]):.2f} ms per tracked frame "
          f"(median; mean {statistics.mean(frame_ms[1:]):.2f}); match {tm['trk.match']:.2f} ms, "
          f"track_step {tm['trk.step']:.2f} ms (means, device-synchronised)", flush=True)

    more = [tds[i] for i in range(len(tds) - N_PROFILED_FRAMES, len(tds))]
    fe.tracker.sync_timing = False

    def track_more():
        for img, info in more:
            fe.process_frame(img, info)

    print(f"phase 7 profile: {profile_window(track_more, N_PROFILED_FRAMES, 'frames')}",
          flush=True)

    src = "artdeco_tpu_torch/csrc/composite.cu"
    print(json.dumps({"kernels": [
        {"name": "composite_fwd", "route": "cuda", "source": src,
         "replaces": "artdeco_tpu/ops/splat/composite.py:113",
         "launches": launches["fwd"], "max_abs_err": big["fwd_err"],
         "ms": big["fwd_ms"], "plain_ms": big["fwd_plain_ms"],
         "bound_ms": big["fwd_bound"], "bound_by": big["fwd_by"], "library_ms": None},
        {"name": "composite_bwd", "route": "cuda", "source": src,
         "replaces": "artdeco_tpu/ops/splat/composite.py:152",
         "launches": launches["bwd"], "max_abs_err": big["bwd_err"],
         "ms": big["bwd_ms"], "plain_ms": big["bwd_plain_ms"],
         "bound_ms": big["bwd_bound"], "bound_by": big["bwd_by"], "library_ms": None},
        {"name": "window_argmax", "route": "cuda", "source": "artdeco_tpu_torch/csrc/refine.cu",
         "replaces": "artdeco_tpu/ops/refine_pallas.py:30",
         "launches": k3_launches, "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
