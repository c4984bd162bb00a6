#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width and checks them: the online
mapper (``MapperStage``) over a 16-frame 512x384 synthetic plane stream at
the ``MapperConfig`` defaults, the tracking frontend (``Frontend`` +
``OracleRunner``) over a 120-frame 512x384 stream with
``config/base.yaml`` as it is, the full ``System`` on the oracle stream,
the model-driven ``System`` (full-width MASt3R and Pi3) through
``run_system.main``, streams read from image files (an image folder and a
TUM sequence) through the entry point, the multi-device path (the
data-parallel mapper, row-strip renders, the edge-sharded GN), and the
viewers (saved scenes loaded back, turntables, the web viewer alone and
beside a running ``System``), and the tools (``artdeco_tpu_torch/scripts/``:
rectification, downsampling, image summaries, videos, the evaluation
matrix and the rigid-transform A/B scripts).

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
8. the full system (``System.run``, overlapped, as users run it): a
   240-frame 512x384 synthetic stream through tracking, the backend (factor
   graph, Sim(3) GN, retrieval) and the mapper at the ``get_args`` and
   ``MapperConfig`` defaults, then ``save`` into a temporary directory.
   Checks: 0 lost, at least 3 keyframes, every keyframe after the first
   ran ``add_factors`` and a GN solve and kept its consecutive edge, no
   frame lookup pulled an image back from the card (the upload thread
   binds each image to its frame), one
   rigid transform of the scene per SLAM keyframe after frame 0, K1/K2/K3
   launches equal to the calls that launch them (K3: tracked matches +
   the backend's symmetric-match rows + its pair matches), ATE RMSE < 0.03
   m, finite test PSNR.  Prints ms per frame and FPS, the stage split,
   peak memory, then runs the stream again sequentially with
   device-synchronised backend timers (keyframe poses within 1e-5 of the
   overlapped run's), the ms per GN solve at its (P, E), and a profile of
   the frames around the second keyframe with the GN's share.
9. the solvers and relocalization on the card: the block-sparse PCG
   against the dense GN on a 264-pose graph at 128x96, 10 iterations
   (poses within 5e-4 in the Sim(3) log, the CPU test's tolerance, and the
   median pose error down 20-fold), and the teleport stream at
   512x384 with a pose-aware stub retrieval: a frame is lost,
   relocalization appends a keyframe near the ground truth, and the frames
   after it track.

10. the model-driven system: (a) the full MASt3R (ViT-L, bf16 trunk,
   float32 heads) on seeded random weights drawn on the card, at 512x384:
   device ms of the encoder, the decoders with heads, a tracking match and
   a symmetric match of 4 edges, peak memory, and the bf16 model against a
   float32 copy of its weights; (b) the full Pi3 over 24 frames at 392x518
   (device ms, peak memory) and the accurate matcher once over 23
   candidates (fractions finite, in [0, 1]); (c) ``run_system.main`` as
   users run it without ``--oracle`` (``--model_size full
   --accurate_loop_closure``, no checkpoint: random weights) over a 16-frame
   512x384 synthetic stream, saved with LPIPS: K1, K2 and K3 must each have
   launched, the metrics must be finite and the entry point must have set
   the float32 policy; prints ms per frame, FPS, the stage split,
   keyframes, lost frames, Pi3 calls and LPIPS.  Random weights give no
   geometry: matches are invalid and frames are lost, so (c) times the
   model path's cost (lost frames run relocalization with Pi3), not its
   tracking.
11. streams from disk, as users run the system on their own frames: (a)
   phase 8's 240 frames written as PNGs with a TUM-format
   ``groundtruth.txt`` and a calibration YAML, read by
   ``SelfCapturedDataset`` and run by ``System.run`` through the Python
   loader (PNG decode, ``to_slam``) with phase 8's arguments: keyframes,
   lost frames, every pose and the test PSNR must be bitwise phase 8's;
   (b) the same folder (its first 80 frames) through ``run_system.main``
   with ``--calib`` and ``--oracle``, the loader the entry point chooses:
   0 lost, phase 8's keyframes, ATE < 0.03 m, ``save``'s files; (c) a TUM
   sequence at 640x480 (``rgb.txt``, ``groundtruth.txt``) through
   ``run_system.main -d tum --downsampling 2 --oracle``: SLAM 512x384 by
   INTER_AREA, map 320x240, 0 lost, at least 2 keyframes, ATE < 0.03 m;
   (d) ``run_system.main`` with ``--model_size full`` on 8 frames of (a)'s
   folder without ``--calib`` or ``--oracle``: the focal guess, the
   estimate from the first frame's pointmap (random weights: a degenerate
   estimate is reported, not failed) and the K_slam used.  (a)-(d) check
   their K1/K2/K3 launches as phase 8 does (on (d)'s model path too, lost
   frames' relocalization matches through the backend's symmetric rows,
   which the count includes); (a) and (b) print the idle
   share of frames 66-73.  ``NATIVE_PHASES`` records whether the card's
   machine can build the native loader (it cannot: no codec headers).

12. the side models and the keypoint-SfM bootstrap, each on seeded
   inputs: (a) XFeat's detector at top_k 4096 and 1024 and its dense
   variant on a 512x384 frame (random weights), the keypoints equal to the
   port's own CPU run of the same weights (but for swaps of near-tied
   scores), descriptors within 1e-4; (b) DepthAnythingV2 at ViT-L width
   (random weights) through ``MonoDepthEstimator`` (392x518 into the net):
   device ms, peak memory, finite non-negative inverse depth; (c)
   ``PoseInitializer.bootstrap`` on frames 0..8 of the 512x384 stream: the
   JAX package's result there, False, with the counts of the port's CPU
   run but for matches decided by near-ties (similarities < 1e-6 apart),
   and the ms of each stage; (d) ``mini_ba`` and ``opt_pnp`` on a
   1024-point scene against its truth; (e) ``knn_mean_sq_dist`` on 10^5
   points against the CPU's and against a brute-force 3-NN; (f) K3's f32
   instance (``refine_dtype: null``) bitwise against its plain version at
   the stream shape, timed beside bf16 K3, and the tracking frontend over
   24 frames with ``refine_dtype: null``: one f32 launch a tracked frame.

13. the multi-device path (``parallel/``, ``System.enable_mesh``) on a
   virtual mesh of 4 slots sharing the one card (``Mesh([cuda:0] * 4)``:
   its times are those of 4 slots on one card, not a scaling measurement):
   (a) ``render_from_id`` and ``render_sharded`` in 4 row strips of 96 rows
   at 512x384 on phase 8's scene and on a random scene of 10^5 Gaussians,
   each against the single-device render of the same view (RGB within
   3e-5, depth within 1e-3 relative, visibility equal, 4 K1 launches a
   render) and timed beside it; (b) one dp step at 256x192 on phase 8's
   state with keyframes [a, b, b, test] against the same step on the CPU
   at ``tests/test_torch_parallel.py``'s tolerances, K1 and K2 launched 4
   times each, timed beside a one-slot step, with the replica copy's
   device time; (c) the edge-sharded GN against the unsharded one on the
   JAX package's dry-run problem (64 edges) and on phase 8's factor graph
   at its final (P, E); (d) ``System.run`` over phase 8's first 80 frames
   with ``System.enable_mesh``: 0 lost, training only through dp steps, K1
   = 4 x (dp steps + sharded renders) + renders, K2 = 4 x dp steps, K3 as
   in phase 8, every GN solve sharded, ATE < 0.03 m; ms per frame, FPS,
   keyframes, ATE, PSNR and Gaussians beside phase 8's.  (e) On a machine
   with 2 or more cards, ``run_system --oracle --n_devices k`` (k = 2 or
   4 distinct cards) on 80 frames, then (a)-(c) over the k cards on that
   run's scene and graph, and K1 launched from a thread whose current
   device is another card; with one card, one line says that (e) did not
   run.

14. the viewers (``runtime/gaussianviewer.py``, ``runtime/webviewer.py``,
   ``scene_io.load_scene_for_viewing``): (a) phase 8's saved directory and
   a saved random scene of 10^5 Gaussians loaded back onto the card, each
   rendered at keyframe 0's view against the live scene with ``d_max``
   lifted (RGB within ``LOADED_TOL`` but on ``LOADED_CUT_SHARE`` of the
   pixels, where a pixel-Gaussian pair may cross the 1/255 alpha cut);
   (b) ``GaussianViewer.export_turntable`` of 60 frames at 640x360 in the
   splat, depth and alpha modes on both loaded scenes: every PNG decodes
   (the port's own decoder) to the turntable's frame bit for bit, the MP4
   holds 60 JPEG samples of 640x360, K1 launches equal the renders; ms a
   frame split into the render (device-synchronised), the copy to the
   host, the PNG and the JPEG encodes; (c) ``WebViewer`` on 127.0.0.1 and
   ``serve_static_page`` on the next port, driven by a standard-library
   client (``WsClient``): requests of 1920x1080 (rendered at 960x540) in
   the splat, depth and ellipsoid modes and with snapToLast on both live
   scenes, every reply a JPEG of 960x540, no failed reply, ``GET /`` the
   port's page; the median reply ms, its split and the replies a second;
   (d) 11b's run again through ``run_system.main --viewer_mode web`` with
   the client polling as the page does for the whole run: keyframes, lost
   frames, every pose and the test PSNR bitwise 11b's, K1 = steps +
   renders + the viewer's renders, K2 and K3 as in 11b, at least one
   reply per 2 s, no failed reply; ms per frame and FPS beside 11b's.

15. the tools, as users run them (``artdeco_tpu_torch/scripts/``; the card's
   machine has no OpenCV): (a) a 40-frame 640x480 TUM sequence seen through
   fr1_desk's lens (each clean frame sampled at the undistorted position of
   every pixel) rectified by ``rectify_tum``: the rectified frames against
   the clean ones inside the mask (max and mean levels, gated at bounds
   from a CPU run of this phase), the mask's zero count equal to the CPU
   run's, ``calib.yaml``'s focal; host ms of one frame's rectification and
   of ``to_slam`` / ``to_map`` with the distortion calibration (the data
   path's undistortion); (b) ``downsampleImage`` at factors 2 and 1.5 on
   641x481 PNGs (sizes; factor 2 is the 2x2 block average),
   ``img_summary``'s CSV, ``img2vid``'s MP4 read back; (c)
   ``train_eval_all --datasets tum`` over three 16-frame 640x480 TUM scenes
   with ``--extra "--oracle --calib ... --seq_length 16"``, each run a
   subprocess of ``python -m artdeco_tpu_torch.run_system`` on the card:
   exit 0, ``run_metadata.json``, 0 lost, ATE < 0.03 m; the first scene's
   command again in this process through ``run_entry``: its trajectories,
   COLMAP poses and Gaussian PLY byte for byte the subprocess's, its
   K1/K2/K3 launches checked as in phase 8 (the ``phase 15c`` counts); (d)
   ``run_debug_rigidtransform.sh`` and ``run_debug_norigidtransform.sh`` on
   a 4-frame 512x384 image folder (no ``--oracle``: random MASt3R weights),
   ``python`` on ``PATH`` being this interpreter: both exit 0 with their
   metadata, a second invocation of each skips its scene, and whether the
   two runs' trajectories and scenes differ.  Any failed subprocess fails
   the phase.

Prints one line per phase, then a JSON line of the kernels and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is then not 0 and the last line is not printed.
"""

import dataclasses
import gc
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
SYS_W, SYS_H, SYS_FRAMES = 512, 384, 240
SYS_PROFILED = (66, 74)     # frames around the second keyframe (frame 70)
CHAIN_POSES, CHAIN_W, CHAIN_H = 264, 128, 96
TELE_WALK, TELE_TOTAL = 52, 58
MODEL_SIZE = "full"          # phase 10: MASt3RConfig() and Pi3Config() ("tiny": test widths)
MODEL_W, MODEL_H = 512, 384  # a MASt3R frame: 32x24 tokens
MODEL_EDGES = 4              # edges of the timed symmetric match (8 decoded pairs)
MODEL_TIMED = 5
PI3_FRAMES = 24              # the accurate matcher's window (23 candidates and the query)
SYS10_FRAMES = 16            # depth of the model-driven System run
DISK_ENTRY_FRAMES = 80       # phase 11b (and 14d): the entry point on the first frames of
                             # 11a's folder, its keyframes 0 and 70
TUM_W, TUM_H, TUM_SLAM, TUM_FRAMES, TUM_TEST_HOLD = 640, 480, 512, 80, 30   # phase 11c
CALIB_FRAMES = 8             # phase 11d
XFEAT_TOPK = (4096, 1024)    # phase 12a
DAV2_ENCODER = "vitl"        # phase 12b: dav2_config("vitl"), the released ViT-L
BOOT_FRAMES = 9              # phase 12c: frames 0..8
SOLVER_POINTS = 1024         # phase 12d
KNN_POINTS = 100_000         # phase 12e
F32_TRACK_FRAMES = 24        # phase 12f
MESH_SLOTS = 4               # phase 13: the virtual mesh, 4 slots on one card
MESH_FRAMES = 80             # phase 13d: the first 80 frames of phase 8's stream
MESH_TIMED = 5
VIEW_W, VIEW_H, VIEW_FRAMES = 640, 360, 60   # phase 14b: visualize_gs's defaults
WEB_RES = (1920, 1080)       # phase 14c, d: the client's window (rendered at 960x540)
LOADED_TOL = 1e-5            # phase 14a: a loaded scene's RGB against the live render
LOADED_CUT_SHARE = 1e-4      # ... but for pixels where a pair crosses the 1/255 alpha cut
# phase 15 runs five entry-point subprocesses, each about 14 s on the card
# before its first frame: its depths were cut (at 80, 40 and 40 frames it
# took 214.4 s on an H100 80GB HBM3 at 700 W) to keep the phase within 120 s
TOOLS_W, TOOLS_H, TOOLS_FRAMES = 640, 480, 40   # phase 15a: TUM's size, fr1_desk's lens
DOWN_FRAMES = 8              # phase 15b: 641x481 PNGs for downsampleImage and img2vid
MATRIX_W, MATRIX_H, MATRIX_FRAMES = 640, 480, 16   # phase 15c: three TUM scenes
AB_W, AB_H, AB_FRAMES = 512, 384, 4                # phase 15d: one image-folder scene
SUBPROCESS_ARGS = ()         # flags added to phase 15's entry-point subprocesses (none on
                             # the card; a CPU rehearsal passes --device cpu)
# phase 15a's gates, set from a CPU run of this phase (the same numpy code
# on the same seeded frames): the rectified frames against the clean ones
# inside the mask (double bilinear resampling of 7-11 px sinusoids), and
# the mask's zero count
RECT_MAX_LEVELS, RECT_MEAN_LEVELS, RECT_MASK_ZEROS = 40, 0.15, 35019   # CPU: 36, 0.1437, 35019
# The H100 machine this script targets has no libjpeg: g++ there reads
# "fatal error: jpeglib.h: No such file or directory", so the native
# loader cannot be built on it.  By this fixed decision phase 11 runs the
# Python loader there and leaves out the native halves of (b) and (c);
# (b) and (c) then check that the entry point chose the Python loader.
NATIVE_PHASES = False

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


class ProfiledFrames:
    """Within the block, every ``System._stream_loop`` (``System.run``'s,
    or a direct call) profiles its frames [first, last) (torch.profiler,
    CPU and CUDA, peak memory counted from its start); ``summary`` and
    ``idle`` read the last window."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.prof = self.ms = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        from artdeco_tpu_torch.runtime import system as S

        self.orig = orig = S.System._stream_loop
        win = self

        def loop(sys_, it, *a, **k):
            def frames():
                for i, item in enumerate(it):
                    if i == win.first:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        win.prof = profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA])
                        win.prof.start()
                        win.t0 = time.perf_counter()
                    if i == win.last:
                        win.stop()
                    yield item

            try:
                return orig(sys_, frames(), *a, **k)
            finally:
                win.stop()

        S.System._stream_loop = loop
        return self

    def stop(self):
        import torch

        if self.prof is not None and self.ms is None:
            torch.cuda.synchronize()
            self.ms = 1e3 * (time.perf_counter() - self.t0)
            self.prof.stop()

    def __exit__(self, *exc):
        from artdeco_tpu_torch.runtime import system as S

        S.System._stream_loop = self.orig

    def idle(self) -> float:
        busy = sum(e.self_device_time_total for e in device_events(self.prof)) / 1e3
        return 1.0 - busy / self.ms

    def summary(self, ranges=()) -> str:
        return summarize_profile(self.prof, self.ms, self.last - self.first, "frames", ranges)


def profile_window(fn, n_steps: int, what: str, ranges=()) -> str:
    """``fn()`` (``n_steps`` steps of ``what``) under torch.profiler: the
    window (host clock), the device's busy time (sum of its kernels,
    memcpys and memsets, one stream) and idle share, the count of device
    kernels, the kernels with the most device time, and the peak device
    memory; for each ``record_function`` range named in ``ranges``, the
    device time of the kernels launched inside it and their share of the
    busy time.  The profiler adds host time to every launch, so the window
    is longer than the same work unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    return summarize_profile(prof, window_ms, n_steps, what, ranges)


def device_events(prof, ranges=()) -> list:
    """The profile's device kernels, memcpys and memsets (key averages);
    a ``record_function`` range's span on the device timeline is not one."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in ranges]


def summarize_profile(prof, window_ms: float, n_steps: int, what: str, ranges=()) -> str:
    """profile_window's summary of a finished profiler run over
    ``window_ms`` of host time."""
    import torch
    from torch.autograd import DeviceType

    dev = device_events(prof, ranges)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    in_ranges = []
    for name in ranges:
        ms = sum(e.device_time_total for e in prof.events()
                 if e.name == name and e.device_type == DeviceType.CPU) / 1e3
        in_ranges.append(f"{name} kernels {ms:.2f} ms ({100 * ms / busy_ms:.1f}% of busy)"
                         if ms > 0 and busy_ms > 0 else f"{name} not measured")
    kernels = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    tops = "; ".join(f"{e.key[:48]} {100 * e.self_device_time_total / 1e3 / busy_ms:.1f}% "
                     f"x{e.count}" for e in top) if busy_ms > 0 else "not measured"
    idle = f"{1 - busy_ms / window_ms:.3f}" if busy_ms > 0 else "not measured"
    return (f"{n_steps} {what}, window {window_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms, idle share {idle}, {kernels} device kernels "
            f"({kernels / n_steps:.0f}/{what.rstrip('s')}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; top: {tops}"
            + "".join(f"; {r}" for r in in_ranges))


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


def register_stream(runner, ds) -> float:
    """Register every frame of ``ds`` with the oracle; returns the seconds."""
    t0 = time.time()
    for i in range(len(ds)):
        img, info = ds[i]
        T = np.ones(8, np.float32)
        T[:7] = info["Twc_gt"]
        runner.register(ds.transform.to_slam(img), i, T)
    return time.time() - t0


def system_args(**overrides):
    """The entry point's arguments for the oracle synthetic stream: every
    ``get_args`` default but the stream's own flags."""
    from artdeco_tpu_torch.dataio.args import get_args

    args = get_args(["-s", "synthetic://", "-d", "synthetic", "--oracle",
                     "--test_hold", str(TEST_HOLD), "--retrieval_checkpoint_path", ""])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def make_system(dev, ds, cfg, args):
    from artdeco_tpu_torch.models.oracle import OracleRunner
    from artdeco_tpu_torch.runtime.system import System

    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=dev)
    reg_s = register_stream(runner, ds)
    return System(args, cfg, ds, runner, device=dev), reg_s


def timers_ms(timers: dict, prefix: str) -> str:
    return ", ".join(f"{k} {1e3 * v[0] / max(v[1], 1):.2f}" for k, v in sorted(timers.items())
                     if k.startswith(prefix)) or "none"


def reset_launches():
    from artdeco_tpu_torch.ops import refine_dense as RD
    from artdeco_tpu_torch.ops.splat import composite as C

    C.composite_fwd.launches = C.composite_bwd.launches = RD.window_argmax.launches = 0
    RD.window_argmax.launches_f32 = 0


def read_launches() -> dict:
    from artdeco_tpu_torch.ops import refine_dense as RD
    from artdeco_tpu_torch.ops.splat import composite as C

    return {"fwd": C.composite_fwd.launches, "bwd": C.composite_bwd.launches,
            "k3": RD.window_argmax.launches, "k3_f32": RD.window_argmax.launches_f32}


def check_system_launches(sys_, launches: dict, what: str) -> str:
    """A System run's K1/K2/K3 launches against the calls that launch them:
    K1 = training steps + renders, K2 = steps, K3 = tracked matches + the
    backend's symmetric-match rows + its pair matches; with a mesh of n
    slots, a dp step launches K1 and K2 n times each and a sharded render
    K1 n times; a web viewer attached to the run adds its renders to K1.
    Returns the line that says so."""
    fe, bk, fg, sm = sys_.frontend, sys_.backend, sys_.backend.factor_graph, sys_.scene_model
    tracked = fe.tracker.timers["trk.match"][1]
    k3_want = tracked + fg.match_rows + bk.pair_matches
    check(launches["k3"] == k3_want, f"{what}: K3 launches {launches['k3']} != {tracked} "
          f"tracked + {fg.match_rows} symmetric rows + {bk.pair_matches} pair matches")
    n = sm._mesh.size if sm._mesh is not None else 0
    steps = sm.n_train_steps + n * sm.n_dp_steps
    viewed = sys_.viewer.renders if sys_.viewer is not None else 0
    renders = sm.n_renders + n * sm.n_sharded_renders + viewed
    mesh = (f" + {n} x {sm.n_dp_steps} dp steps" if n else "",
            f" + {n} x {sm.n_sharded_renders} sharded renders" if n else "")
    if sys_.viewer is not None:
        mesh = (mesh[0], mesh[1] + f" + {viewed} web viewer renders")
    check(launches["bwd"] == steps > 0, f"{what}: K2 launches {launches['bwd']} != "
          f"{sm.n_train_steps} training steps{mesh[0]}")
    check(launches["fwd"] == steps + renders,
          f"{what}: K1 launches {launches['fwd']} != {sm.n_train_steps} steps{mesh[0]} + "
          f"{sm.n_renders} renders{mesh[1]}")
    return (f"launches K1 {launches['fwd']} (= {sm.n_train_steps} steps{mesh[0]} + "
            f"{sm.n_renders} renders{mesh[1]}) K2 {launches['bwd']} K3 {launches['k3']} (= "
            f"{tracked} tracked + {fg.match_rows} symmetric rows + {bk.pair_matches} pair "
            f"matches)")


def full_system_phase(dev, cfg):
    """Phase 8: the full System, overlapped, then sequentially (see the
    module docstring).  Returns the kernels' launch counts of the
    overlapped run and what phase 11a holds its run from disk to: the
    stream, its keyframes, every frame's pose, the test PSNR, ms per frame
    and FPS."""
    import tempfile

    import torch
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
    from artdeco_tpu_torch.runtime.system import _Prefetcher, _UploadAhead

    args = system_args(max_size_slam=SYS_W)
    ds = SyntheticDataset(args, n_frames=SYS_FRAMES, width=SYS_W, height=SYS_H)
    check((ds.W_slam, ds.H_slam, ds.W_map, ds.H_map) == (SYS_W, SYS_H, SYS_W, SYS_H),
          "full-system resolution")
    sys_, reg_s = make_system(dev, ds, cfg, args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    sys_.run(progress=False)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    meta = sys_.save(out_dir)
    torch.cuda.synchronize()
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    fe, bk, fg, sm = sys_.frontend, sys_.backend, sys_.backend.factor_graph, sys_.scene_model
    n_kf = len(sys_.keyframes)
    kf_frames = sys_.keyframes.dataset_idx[:n_kf].tolist()
    check(fe.lost_number == 0, f"{fe.lost_number} frames lost")
    check(n_kf >= 3, f"{n_kf} keyframes")
    check(len(fg.solves) == n_kf - 1, f"{len(fg.solves)} GN solves for {n_kf} keyframes")
    pairs = set(zip(fg.ii, fg.jj))
    missing = [k for k in range(1, n_kf) if (k - 1, k) not in pairs]
    check(not missing, f"keyframes {missing} lost their consecutive edge")
    check(sys_.mapper.rigid_transforms == n_kf - 1,
          f"{sys_.mapper.rigid_transforms} rigid transforms for {n_kf} keyframes")
    launch_line = check_system_launches(sys_, launches, "phase 8")
    ate = meta["trajectory"]["APE"]["rmse"]
    psnr = meta["metrics"].get("PSNR", float("nan"))
    check(ate < 0.03, f"ATE RMSE {ate} m")
    lookups = fe.runner.d2h_lookups
    check(lookups == 0, f"{lookups} frame lookups pulled an image back from the card")
    check(meta["metrics"].get("n_test_frames", 0) >= 1 and np.isfinite(psnr),
          f"test PSNR {psnr}")
    for rel in ("run_metadata.json", "metadata.json", "slam/frames.txt", "slam/keyframes.txt",
                "point_clouds/gs.ply", "colmap/images.bin", "onthefly.txt"):
        check(os.path.isfile(os.path.join(out_dir, rel)), f"save wrote no {rel}")
    frame_ms = [1e3 * x for x in sys_.frame_s]
    rt = sys_.runtimes.summary()
    print(f"phase 8 full system: {SYS_FRAMES} frames {SYS_W}x{SYS_H} overlapped (oracle "
          f"registered in {reg_s:.1f} s); lost {fe.lost_number}; keyframes {n_kf} at frames "
          f"{kf_frames}; GN solves {len(fg.solves)} at (P, E, edges) {fg.solves}; kept pairs "
          f"{sorted(pairs)}; rigid transforms {sys_.mapper.rigid_transforms}; mapper frames "
          f"{sys_.mapper_index}; {launch_line}; ATE RMSE {ate:.5f} m; frame lookups that pulled an image {lookups}; test PSNR "
          f"{psnr:.2f} dB SSIM {meta['metrics']['SSIM']:.4f}; "
          f"Gaussians {meta['n_gaussians']}", flush=True)
    print(f"phase 8 timing: {statistics.median(frame_ms):.2f} ms per frame (median; mean "
          f"{statistics.mean(frame_ms):.2f}, max {max(frame_ms):.1f}), {SYS_FRAMES / run_s:.2f} "
          f"FPS over the run ({run_s:.1f} s, the worker's drain included); stage ms per call: "
          f"track {rt.get('track', 0):.2f}, backend {rt.get('backend', 0):.2f} (per "
          f"message), map {rt.get('map', 0):.2f} (per work item, worker thread); peak memory "
          f"{peak_mib:.1f} MiB", flush=True)
    kf_T = sys_.keyframes.T_WC[:n_kf].copy()
    # phase 13 runs the multi-device path on this run's scene and graph,
    # phase 14 the viewers on its scene and its saved directory
    ref = dict(ds=ds, out_dir=out_dir, kf_frames=kf_frames, est=fe.estimated_trajectory(),
               psnr=psnr, lost=fe.lost_number, ms=statistics.median(frame_ms),
               fps=SYS_FRAMES / run_s,
               ate=ate, n_gaussians=meta["n_gaussians"], scene_model=sm, factor_graph=fg)
    del sys_, fe, bk, fg, sm
    gc.collect()
    torch.cuda.empty_cache()

    # the same stream sequentially, device-synchronised backend timers, and
    # a profile of the frames around the second keyframe
    seq, _ = make_system(dev, ds, cfg, system_args(max_size_slam=SYS_W))
    seq.backend.sync_timing = True
    it = _UploadAhead(_Prefetcher(ds), ds.transform, dev, runner=seq.frontend.runner)

    import contextlib

    t0 = time.time()
    try:
        with ProfiledFrames(*SYS_PROFILED) as window:
            seq._stream_loop(it, None, None, lambda name: contextlib.nullcontext())
    finally:
        it.close()
    torch.cuda.synchronize()
    seq_s = time.time() - t0
    n2 = len(seq.keyframes)
    check(n2 == n_kf and seq.keyframes.dataset_idx[:n2].tolist() == kf_frames,
          f"sequential keyframes {seq.keyframes.dataset_idx[:n2].tolist()} != {kf_frames}")
    pose_diff = float(np.abs(seq.keyframes.T_WC[:n2] - kf_T).max())
    check(pose_diff <= 1e-5, f"sequential keyframe poses {pose_diff} from the overlapped run's")
    gn = seq.backend.factor_graph.timers.get("gn.solve", [0.0, 0])
    print(f"phase 8 sequential: keyframes {kf_frames}, poses within {pose_diff:.3g} of the "
          f"overlapped run's; {statistics.median([1e3 * x for x in seq.frame_s]):.2f} ms per "
          f"frame (median; mean {statistics.mean([1e3 * x for x in seq.frame_s]):.2f}), "
          f"{SYS_FRAMES / seq_s:.2f} FPS ({seq_s:.1f} s, its profiled window included); "
          f"device-synchronised ms per call: "
          f"{timers_ms(seq.backend.timers, 'bkd.')}; "
          f"{timers_ms(seq.backend.factor_graph.timers, 'fg.')}; "
          f"{timers_ms(seq.backend.factor_graph.timers, 'gn.')}; GN solve "
          f"{1e3 * gn[0] / max(gn[1], 1):.2f} ms at (P, E, edges) "
          f"{seq.backend.factor_graph.solves}", flush=True)
    print(f"phase 8 profile: {window.summary(('gn.solve',))}", flush=True)
    return launches, ref



def chain_graph(n_poses: int, w: int, h: int, seed: int = 1):
    """``tests/test_torch_global_opt.py``'s graph at w x h: a zigzag of
    exact 2-pixel x-translations over a plane (identity rotations), joined
    to its neighbours at 1 and 4 poses and, every 16 poses, to pose 0;
    every match integer-exact.  Returns numpy (T_gt, Xs, Cs, K, ii, jj,
    idx, vm, Q, edge_valid, used) with E padded to a power of two."""
    f = 0.8 * w
    K = np.asarray([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    tx = 2.0 * 2.0 / f
    T_gt = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (n_poses, 1))
    shift = 2 * (np.arange(n_poses) % 4)            # pixels
    T_gt[:, 0] = (np.arange(n_poses) % 4) * tx
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    rays = np.stack([(u - w / 2) / f, (v - h / 2) / f, np.ones_like(u, dtype=np.float64)], -1)
    X = (2.0 * rays).reshape(-1, 3).astype(np.float32)   # the plane z = 2, t_z = 0
    edges = []
    for step in (1, 4):
        for i in range(n_poses - step):
            edges += [(i, i + step), (i + step, i)]
    for k in range(16, n_poses, 16):
        edges += [(0, k), (k, 0)]
    E = 1
    while E < len(edges):
        E *= 2
    hw = h * w
    ii, jj = np.zeros(E, np.int32), np.zeros(E, np.int32)
    idx, vm = np.zeros((E, hw), np.int32), np.zeros((E, hw), bool)
    ev = np.zeros(E, bool)
    uf, vf = u.reshape(-1), v.reshape(-1)
    for e, (i, j) in enumerate(edges):
        ui = uf + shift[j] - shift[i]                   # pixel of frame j's point in i
        ok = (ui >= 1) & (ui < w - 1) & (vf >= 1) & (vf < h - 1)
        ii[e], jj[e], ev[e] = i, j, True
        idx[e] = np.clip(vf * w + ui, 0, hw - 1)
        vm[e] = ok
    Xs = np.broadcast_to(X, (n_poses, hw, 3)).copy()
    Cs = np.full((n_poses, hw, 1), 5.0, np.float32)
    Q = np.full((E, hw, 1), 4.0, np.float32)
    return T_gt, Xs, Cs, K, ii, jj, idx, vm, Q, ev, np.ones(n_poses, bool)


def solver_golden(dev) -> str:
    """Phase 9a: the PCG solver against the dense GN on the chain graph."""
    import torch
    from artdeco_tpu_torch.geometry import lie
    from artdeco_tpu_torch.vslam import global_opt as go

    T_gt, *arrays = chain_graph(CHAIN_POSES, CHAIN_W, CHAIN_H)
    Xs, Cs, K, ii, jj, idx, vm, Q, ev, used = (torch.as_tensor(a, device=dev) for a in arrays)
    g = torch.Generator().manual_seed(1)
    xi = 0.08 * torch.randn(CHAIN_POSES, 7, generator=g)
    xi[0] = 0
    T0 = lie.sim3_mul(lie.sim3_exp(xi.to(dev)), torch.as_tensor(T_gt, device=dev))
    kw = dict(max_iter=10, delta_thresh=1e-10, chunk=32)     # config's max_iters
    out = {}
    for name, solver in (("dense", go.gauss_newton_calib),
                         ("sparse", go.gauss_newton_calib_sparse)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = solver(T0, Xs, Cs, K, ii, jj, idx, vm, Q, ev, used, CHAIN_H, CHAIN_W, **kw)
        torch.cuda.synchronize()
        out[name + "_ms"] = 1e3 * (time.perf_counter() - t0)

    def err(a, b):
        return torch.linalg.vector_norm(lie.sim3_log(lie.sim3_mul(lie.sim3_inv(a), b)), dim=-1)

    gap = float(err(out["dense"], out["sparse"]).max())
    Tg = torch.as_tensor(T_gt, device=dev)
    e0, e1 = float(err(T0, Tg)[1:].median()), float(err(out["sparse"], Tg)[1:].median())
    check(gap < 5e-4, f"PCG and dense GN poses {gap} apart in the Sim(3) log")
    check(e1 < 0.05 * e0, f"PCG pose error {e1} from {e0}")
    return (f"chain of {CHAIN_POSES} poses at {CHAIN_W}x{CHAIN_H}, {int(ev.sum())} directed "
            f"edges (E {len(ev)}), 10 GN iterations: PCG and dense poses {gap:.3g} apart "
            f"(Sim(3) log, max); median pose error {e0:.4f} -> {e1:.3g}; dense "
            f"{out['dense_ms']:.1f} ms, PCG {out['sparse_ms']:.1f} ms (host clock, first call)")


class _StubRetrieval:
    """Pose-aware retrieval stand-in (``tests/test_reloc.py``'s): the
    stored keyframes whose ground-truth x lies within ``overlap_x`` of the
    query frame's (the oracle's token carries the frame id)."""

    def __init__(self, dataset, keyframes, overlap_x):
        self.dataset, self.keyframes, self.overlap_x = dataset, keyframes, overlap_x
        self._stored: list = []

    def update(self, feat, add_after_query=True, k=3, min_thresh=0.0):
        fid = int(np.asarray(feat)[0, 0])
        x_q = self.dataset.Twc_gt[fid][0]
        hits = [kf for kf, f in self._stored
                if abs(self.dataset.Twc_gt[f][0] - x_q) < self.overlap_x]
        if add_after_query:
            self._stored.append((len(self.keyframes) - 1 if len(self.keyframes) else 0, fid))
        return hits[:k]


def teleport_phase(dev, cfg) -> str:
    """Phase 9b: ``tests/test_reloc.py``'s teleport protocol at 512x384,
    its steps scaled to the width (12.8 px a frame): a walk of 3.25 units
    along x (the view is 2.5 units wide), then back near the origin."""
    import copy

    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
    from artdeco_tpu_torch.runtime.system import System

    args = system_args(max_size_slam=SYS_W, test_hold=-1, num_key_iterations=2,
                       num_common_iterations=1)
    ds = SyntheticDataset(args, n_frames=TELE_TOTAL, width=SYS_W, height=SYS_H)
    step = 3.25 / TELE_WALK
    poses = np.zeros((TELE_TOTAL, 7))
    poses[:, 6] = 1.0
    for i in range(TELE_TOTAL):
        poses[i, 0] = step * i if i < TELE_WALK else 0.05 + 0.08 * step * (i - TELE_WALK)
    ds.Twc_gt = poses
    tcfg = copy.deepcopy(cfg)
    tcfg["tracking"]["match_frac_thresh"] = 0.95
    from artdeco_tpu_torch.models.oracle import OracleRunner

    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, tcfg["matching"], device=dev)
    register_stream(runner, ds)
    sys_ = System(args, tcfg, ds, runner, retrieval="stub", device=dev)
    sys_.backend.retrieval = _StubRetrieval(ds, sys_.keyframes, overlap_x=1.0)
    sys_.run(progress=False)
    lost = sys_.frontend.lost_number
    n_kf = len(sys_.keyframes)
    fids = sys_.keyframes.dataset_idx[:n_kf].tolist()
    post = [i for i, f in enumerate(fids) if f >= TELE_WALK]
    check(lost >= 1, "the teleport lost no frame")
    check(bool(post), f"no keyframe after the teleport (keyframes at {fids})")
    errs = [float(np.abs(sys_.keyframes.T_WC[i][:3] - ds.Twc_gt[fids[i]][:3]).max())
            for i in post]
    check(max(errs) < 0.15, f"post-teleport keyframe position errors {errs}")
    est = sys_.frontend.estimated_trajectory()
    after = [r for r in est if int(r[0]) > TELE_WALK]
    check(len(after) >= 2, f"{len(after)} tracked frames after the teleport (lost {lost}, "
          f"keyframes at {fids}, tracked frames {[int(r[0]) for r in est]})")
    x_err = max(abs(r[1] - ds.Twc_gt[int(r[0])][0]) for r in after)
    check(x_err < 0.2, f"post-teleport frames {x_err} from ground truth in x")
    return (f"teleport stream {SYS_W}x{SYS_H}, {TELE_TOTAL} frames (walk {TELE_WALK} x "
            f"{step:.4f}): lost {lost}; keyframes {n_kf}, the relocalized ones at frames "
            f"{[fids[i] for i in post]} within {max(errs):.4f} of ground truth; "
            f"{len(after)} frames tracked after it, within {x_err:.4f} in x")

def model_frames(n: int, w: int, h: int, dev):
    """``n`` SLAM images (3, h, w) in [-1, 1] of the synthetic stream on
    ``dev``, 8 frames apart."""
    import torch
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset

    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=w),
                          n_frames=8 * n, width=w, height=h)
    return [torch.as_tensor(ds.transform.to_slam(ds[8 * i][0]), device=dev) for i in range(n)]


def mast3r_phase(dev, cfg) -> str:
    """Phase 10a: the full MASt3R (bf16 trunk, float32 heads) on seeded
    random weights drawn on the card, at 512x384: device ms of the encoder,
    of both decoders plus heads, of a tracking match (the keyframe's
    embedding reused, one encode) and of a symmetric match of
    ``MODEL_EDGES`` edges; peak memory; the bf16 model against a float32
    copy of the same weights (points, descriptors)."""
    import torch
    from artdeco_tpu_torch.models import mast3r as M
    from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner

    mcfg = M.MASt3RConfig() if MODEL_SIZE == "full" else M.tiny_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.time()
    runner = Mast3rRunner.create(mcfg, cfg["matching"], device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in runner.model.parameters())
    img_i, img_j = model_frames(2, MODEL_W, MODEL_H, dev)
    hw = (MODEL_H, MODEL_W)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    emb_i, emb_j = runner.encode_image(img_i[None]), runner.encode_image(img_j[None])
    enc_ms = cuda_ms(lambda: runner.encode_image(img_i[None]), MODEL_TIMED)
    dec_ms = cuda_ms(lambda: runner.decode(*emb_i, *emb_j, hw), MODEL_TIMED)
    asym_ms = cuda_ms(lambda: runner.match_asymmetric(img_i, img_j, embeddings_j=emb_j),
                      MODEL_TIMED)
    b = MODEL_EDGES
    fi, pi = emb_i[0].expand(b, -1, -1), emb_i[1].expand(b, -1, -1)
    fj, pj = emb_j[0].expand(b, -1, -1), emb_j[1].expand(b, -1, -1)
    sym = runner.match_symmetric(fi, pi, fj, pj, hw)
    sym_ms = cuda_ms(lambda: runner.match_symmetric(fi, pi, fj, pj, hw), MODEL_TIMED)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    prof = profile_window(lambda: runner.match_asymmetric(img_i, img_j, embeddings_j=emb_j),
                          1, "matches")
    r1, r2 = runner.decode(*emb_i, *emb_j, hw)
    for r in (r1, r2):
        for k, v in r.items():
            check(bool(torch.isfinite(v).all()), f"MASt3R {k} not finite")
    check(all(bool(torch.isfinite(q).all()) for q in sym[4:]), "symmetric match Q not finite")
    # the same weights in float32: the bf16 trunk's values are exact in f32
    cfg32 = dataclasses.replace(mcfg, compute_dtype=torch.float32)
    f32 = Mast3rRunner(cfg32, M.empty_mast3r(cfg32, dev), cfg["matching"], device=dev)
    f32.model.load_state_dict(runner.model.state_dict())
    q1, _ = f32.decode(*f32.encode_image(img_i[None]), *f32.encode_image(img_j[None]), hw)
    x_err = float((r1["pts3d"] - q1["pts3d"]).abs().max() / q1["pts3d"].abs().max())
    cos = (r1["desc"] * q1["desc"]).sum(-1)
    del f32, q1
    gc.collect()
    torch.cuda.empty_cache()
    return (f"MASt3R {MODEL_SIZE} ({n_params / 1e6:.1f} M parameters, random weights drawn "
            f"on the card in {build_s:.1f} s) at {MODEL_W}x{MODEL_H}: encoder "
            f"{enc_ms:.3f} ms, decoders + heads {dec_ms:.3f} ms, match_asymmetric (one "
            f"encode) {asym_ms:.3f} ms, match_symmetric of {b} edges {sym_ms:.3f} ms "
            f"(device ms, median of {MODEL_TIMED}; the matches sync the host once a row); "
            f"peak memory {peak_mib:.1f} MiB; bf16 against a float32 copy: points within "
            f"{x_err:.3g} of their largest magnitude, descriptor cosine mean "
            f"{float(cos.mean()):.5f} min {float(cos.min()):.5f}; profile of one "
            f"match_asymmetric: {prof}")


def pi3_phase(dev, cfg) -> str:
    """Phase 10b: the full Pi3 on seeded random weights drawn on the card,
    ``PI3_FRAMES`` frames jointly at 392x518: device ms and peak memory;
    then the accurate matcher once over 23 candidates and the query (from a
    keyframe store at 512x384): fractions finite and in [0, 1]."""
    import torch
    from artdeco_tpu_torch.models.pi3 import load_pi3_apply
    from artdeco_tpu_torch.vslam.accurate_lc import make_pi3_accurate_matcher
    from artdeco_tpu_torch.vslam.frame import Frame
    from artdeco_tpu_torch.vslam.keyframes import KeyframeStore

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.time()
    apply, (h, w) = load_pi3_apply("", full=MODEL_SIZE == "full", device=dev, generator=gen)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in apply.model.parameters())
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    imgs = torch.rand(1, PI3_FRAMES, 3, h, w, generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = apply(imgs)
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"Pi3 {k} not finite")
    ms = cuda_ms(lambda: apply(imgs), 3)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    store = KeyframeStore(MODEL_H, MODEL_W, buffer=PI3_FRAMES, device=dev)
    T = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=torch.float32, device=dev)
    for k, img in enumerate(model_frames(PI3_FRAMES, MODEL_W, MODEL_H, dev)):
        store.append(Frame(img=img, T_WC=T, X_canon=None, C=None, N=None, frame_id=k,
                           frame_time=float(k)))
    matcher = make_pi3_accurate_matcher(apply, store, cfg["matching"], resize_hw=(h, w),
                                        pad_to=PI3_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fracs = matcher(list(range(PI3_FRAMES - 1)), PI3_FRAMES - 1)
    match_ms = 1e3 * (time.perf_counter() - t0)
    check(len(fracs) == PI3_FRAMES - 1 and all(0.0 <= f <= 1.0 for f in fracs),
          f"accurate matcher fractions {fracs}")
    del apply, out, matcher
    gc.collect()
    torch.cuda.empty_cache()
    return (f"Pi3 {MODEL_SIZE} ({n_params / 1e6:.1f} M parameters, random weights drawn on "
            f"the card in {build_s:.1f} s), {PI3_FRAMES} frames at {w}x{h}: {ms:.2f} ms "
            f"(device ms, median of 3), peak memory {peak_mib:.1f} MiB; accurate matcher "
            f"over {PI3_FRAMES - 1} candidates: {match_ms:.1f} ms (host clock, synchronised), "
            f"fractions {min(fracs):.4f}..{max(fracs):.4f}")


def model_system_phase(dev) -> tuple:
    """Phase 10c: ``run_system.main`` as users run it, without ``--oracle``:
    the full MASt3R and Pi3 accurate loop closure on random weights (no
    checkpoint: the entry point warns and draws them), ``SYS10_FRAMES``
    frames of the synthetic stream at 512x384 (the dataset factory is
    pointed at that stream; every flag is the entry point's), saved with
    LPIPS.  Returns (summary, launches of K1, K2, K3 in the run)."""
    import tempfile

    import torch
    from artdeco_tpu_torch.dataio import dataset as D

    def stream(args):
        return D.SyntheticDataset(args, n_frames=SYS10_FRAMES, width=MODEL_W, height=MODEL_H)

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_model_")
    argv = ["-s", "synthetic://", "-d", "synthetic", "--model_size", MODEL_SIZE,
            "--accurate_loop_closure", "--test_hold", str(TEST_HOLD), "--max_size_slam",
            str(MODEL_W), "--checkpoint_path", "", "--retrieval_checkpoint_path", "",
            "--pi3_checkpoint_path", "", "-m", out_dir]
    load = D.load_dataset
    D.load_dataset = stream
    torch.cuda.reset_peak_memory_stats()
    try:
        meta, sys_, run_s, launches = run_entry(argv)
    finally:
        D.load_dataset = load
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "the entry point left TF32 on")
    for k in ("fwd", "bwd", "k3"):
        check(launches[k] > 0, f"the model-driven System launched no {k}")
    metrics = meta["metrics"]
    check(all(np.isfinite(v) for v in metrics.values()), f"metrics {metrics}")
    check(meta["n_frames"] == SYS10_FRAMES, f"{meta['n_frames']} frames")
    pi3_calls = sys_.backend.retrieval.accurate_matcher.calls
    n_kf = len(sys_.keyframes)
    frame_ms = [1e3 * x for x in sys_.frame_s]
    rt = meta["runtimes_ms"]
    lpips = metrics.get("LPIPS")
    if lpips is None:
        # no test frame reached the mapper (random weights lose frames):
        # LPIPS of keyframe 0's render against its image, a training view
        from artdeco_tpu_torch.eval.lpips import get_default_lpips

        sm = sys_.scene_model
        render = sm.render_from_id(0, pyr_lvl=0)["render"]
        kf0_lpips = float(get_default_lpips()(render, sm.keyframes[0].image_pyr[0].to(dev)))
        check(np.isfinite(kf0_lpips), f"keyframe 0 LPIPS {kf0_lpips}")
    summary = (
        f"run_system.main {' '.join(argv[:-2])}: {SYS10_FRAMES} frames {MODEL_W}x{MODEL_H} "
        f"in {run_s:.1f} s (model build and save included); "
        f"{statistics.median(frame_ms):.2f} ms per frame (median; mean "
        f"{statistics.mean(frame_ms):.2f}, max {max(frame_ms):.1f}), {meta['FPS']:.2f} FPS; "
        f"stage ms per call: track {rt.get('track', 0):.2f}, backend {rt.get('backend', 0):.2f}"
        f", map {rt.get('map', 0):.2f}; keyframes {n_kf} at frames "
        f"{sys_.keyframes.dataset_idx[:n_kf].tolist()}; lost {sys_.frontend.lost_number}; "
        f"mapper frames {sys_.mapper_index}; Pi3 calls {pi3_calls}; launches K1 "
        f"{launches['fwd']} K2 {launches['bwd']} K3 {launches['k3']}; test frames "
        f"{metrics.get('n_test_frames', 0)}, PSNR {metrics.get('PSNR', float('nan')):.2f} dB, "
        + (f"LPIPS {lpips:.4f}" if lpips is not None else
           f"LPIPS none (no test frame), keyframe 0's render {kf0_lpips:.4f}")
        + f"; Gaussians "
        f"{meta['n_gaussians']}; peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"MiB")
    del sys_
    gc.collect()
    torch.cuda.empty_cache()
    return summary, launches


def write_stream(ds, root: str, tum: bool = False) -> str:
    """``ds``'s frames as PNG files (the port's ``write_png``) with a
    TUM-format ``groundtruth.txt`` of its poses: ``root/images/<name>`` for
    an image folder, or ``root/rgb/<timestamp>.png`` listed in ``rgb.txt``
    (30 Hz) for a TUM sequence.  Returns the path of a calibration YAML
    with ``ds``'s intrinsics [0.8 W, 0.8 W, W / 2, H / 2]."""
    import yaml
    from artdeco_tpu_torch.dataio.tum_io import save_tum_trajectory
    from artdeco_tpu_torch.mapper.scene_io import write_png

    ts = np.asarray(ds.timestamp, np.float64)
    if tum:
        ts = 1305031102.175304 + np.arange(len(ds)) / 30.0
        os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
        with open(os.path.join(root, "rgb.txt"), "w") as f:
            for i in range(len(ds)):
                rel = f"rgb/{ts[i]:.6f}.png"
                write_png(os.path.join(root, rel), ds[i][0])
                f.write(f"{ts[i]:.6f} {rel}\n")
    else:
        os.makedirs(os.path.join(root, "images"), exist_ok=True)
        for i in range(len(ds)):
            write_png(os.path.join(root, "images", ds.image_name_list[i]), ds[i][0])
    save_tum_trajectory(os.path.join(root, "groundtruth.txt"), ts, ds.Twc_gt)
    path = os.path.join(root, "calib.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"width": ds.W, "height": ds.H,
                        "calibration": [0.8 * ds.W, 0.8 * ds.W, ds.W / 2, ds.H / 2]}, f)
    return path


def run_entry(argv) -> tuple:
    """``run_system.main(argv)`` as users run it, the kernels' launch
    counts set to 0 just before it and read just after.  Returns (its
    metadata, the System it ran, its seconds, the launches)."""
    import torch
    from artdeco_tpu_torch import run_system
    from artdeco_tpu_torch.runtime import system as S

    seen = {}
    save = S.System.save

    def keep(self, out_dir):
        seen["system"] = self
        return save(self, out_dir)

    S.System.save = keep
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    try:
        meta = run_system.main(argv)
    finally:
        S.System.save = save
    torch.cuda.synchronize()
    return meta, seen["system"], time.time() - t0, read_launches()


def host_decode_line(ds, n: int = 8) -> str:
    """Host ms per frame of decoding ``ds``'s first ``n`` frames and of
    their ``to_slam`` and ``to_map``, as the Python loader runs them."""
    t0 = time.perf_counter()
    imgs = [ds[i][0] for i in range(n)]
    t1 = time.perf_counter()
    for img in imgs:
        ds.transform.to_slam(img)
    t2 = time.perf_counter()
    for img in imgs:
        ds.transform.to_map(img)
    t3 = time.perf_counter()
    return (f"host ms per frame over {n}: decode {1e3 * (t1 - t0) / n:.2f}, to_slam "
            f"{1e3 * (t2 - t1) / n:.2f}, to_map {1e3 * (t3 - t2) / n:.2f}")


def frame_ms_line(sys_, n: int, run_s: float) -> str:
    ms = [1e3 * x for x in sys_.frame_s]
    return (f"{statistics.median(ms):.2f} ms per frame (median; mean {statistics.mean(ms):.2f}),"
            f" {n / run_s:.2f} FPS over the run ({run_s:.1f} s)")


def disk_stream_phase(dev, cfg, ref) -> tuple:
    """Phase 11: streams from disk (see the module docstring).  ``ref`` is
    phase 8's in-memory run.  Returns the kernels' launch counts by part
    and what phase 14d holds its run to: 11b's argv, keyframes, lost
    frames, every pose, test PSNR, ms per frame and FPS."""
    import tempfile
    import warnings

    import torch
    from artdeco_tpu_torch.dataio.dataset import SelfCapturedDataset, SyntheticDataset
    from artdeco_tpu_torch.runtime import native_loader

    want_loader = "native" if NATIVE_PHASES else "python"
    why = native_loader.missing_toolchain()
    print(f"phase 11 loader: the native loader "
          + ("can be built here" if why is None else f"cannot be built here ({why})")
          + f"; native phases {'on' if NATIVE_PHASES else 'off'} by this script's fixed "
          f"decision (NATIVE_PHASES)", flush=True)
    launches = {}

    # (a) phase 8's stream from PNG files, the Python loader, bit for bit
    root = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    t0 = time.time()
    calib = write_stream(ref["ds"], root)
    write_s = time.time() - t0
    args = system_args(max_size_slam=SYS_W, dataset_name="selfCaptured", source_path=root,
                       calib=calib)
    ds = SelfCapturedDataset(args)
    check(len(ds) == SYS_FRAMES and np.array_equal(ds.K_slam, ref["ds"].K_slam)
          and (ds.W_slam, ds.H_slam, ds.W_map, ds.H_map) == (SYS_W, SYS_H, SYS_W, SYS_H),
          "phase 11a: the folder's dataset is not phase 8's stream")
    decode_a = host_decode_line(ds)
    sys_, reg_s = make_system(dev, ds, cfg, args)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    with ProfiledFrames(*SYS_PROFILED) as win_a:
        sys_.run(progress=False, use_native_loader=False)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    meta = sys_.save(tempfile.mkdtemp(prefix="chip_smoke_disk_out_"))
    launches["phase 11a"] = read_launches()
    line = check_system_launches(sys_, launches["phase 11a"], "phase 11a")
    n_kf = len(sys_.keyframes)
    kf = sys_.keyframes.dataset_idx[:n_kf].tolist()
    est = sys_.frontend.estimated_trajectory()
    psnr = meta["metrics"].get("PSNR", float("nan"))
    check(sys_.loader == "python", f"phase 11a ran the {sys_.loader} loader")
    if est.shape != ref["est"].shape or not np.array_equal(est, ref["est"]):
        rows = (np.nonzero(np.any(est != ref["est"], axis=1))[0]
                if est.shape == ref["est"].shape else [0])
        check(False, f"phase 11a: poses differ from phase 8's from frame {int(rows[0])} "
              f"({est.shape} against {ref['est'].shape})")
    check(kf == ref["kf_frames"], f"phase 11a: keyframes {kf} != phase 8's {ref['kf_frames']}")
    check(sys_.frontend.lost_number == ref["lost"] == 0,
          f"phase 11a: {sys_.frontend.lost_number} lost")
    check(psnr == ref["psnr"], f"phase 11a: test PSNR {psnr!r} != phase 8's {ref['psnr']!r}")
    print(f"phase 11a folder, Python loader: {SYS_FRAMES} PNG frames {SYS_W}x{SYS_H} written in "
          f"{write_s:.1f} s, oracle registered in {reg_s:.1f} s; keyframes {kf}, lost "
          f"{sys_.frontend.lost_number}, every pose and the test PSNR {psnr!r} dB bitwise "
          f"phase 8's; {line}; {frame_ms_line(sys_, SYS_FRAMES, run_s)} (phase 8 "
          f"{ref['ms']:.2f} ms, {ref['fps']:.2f} FPS); idle share {win_a.idle():.3f} over "
          f"frames {SYS_PROFILED[0]}-{SYS_PROFILED[1] - 1} (profiled); {decode_a}", flush=True)
    idle_a = win_a.idle()
    del sys_
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same folder through the entry point, default loader
    out_b = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    argv = ["-s", root, "--calib", calib, "--oracle", "--test_hold", str(TEST_HOLD),
            "--max_size_slam", str(SYS_W), "--retrieval_checkpoint_path", "",
            "--seq_length", str(DISK_ENTRY_FRAMES), "-m", out_b]
    with ProfiledFrames(*SYS_PROFILED) as win_b:
        meta, sys_, run_s, launches["phase 11b"] = run_entry(argv)
    line = check_system_launches(sys_, launches["phase 11b"], "phase 11b")
    check(sys_.loader == want_loader, f"phase 11b ran the {sys_.loader} loader, "
          f"not the {want_loader} one")
    n_kf = len(sys_.keyframes)
    kf = sys_.keyframes.dataset_idx[:n_kf].tolist()
    want_kf = [k for k in ref["kf_frames"] if k < DISK_ENTRY_FRAMES]
    ate = meta["trajectory"]["APE"]["rmse"]
    check(sys_.frontend.lost_number == 0, f"phase 11b: {sys_.frontend.lost_number} lost")
    check(kf == want_kf, f"phase 11b: keyframes {kf} != phase 8's {want_kf}")
    check(ate < 0.03, f"phase 11b: ATE RMSE {ate} m")
    for rel in ("run_metadata.json", "metadata.json", "slam/frames.txt", "slam/keyframes.txt",
                "point_clouds/gs.ply", "colmap/images.bin", "onthefly.txt"):
        check(os.path.isfile(os.path.join(out_b, rel)), f"phase 11b: save wrote no {rel}")
    diff = ""
    if NATIVE_PHASES:
        pf = native_loader.NativePrefetcher(sys_.dataset.image_paths, sys_.dataset.transform)
        err = max(float(np.abs(pf.get()[0] - sys_.dataset.transform.to_slam(
            sys_.dataset[i][0])).max()) for i in range(8))
        pf.close()
        diff = f"; native SLAM tensors within {err:.3g} of to_slam's (8 frames)"
    disk_ref = dict(argv=argv[:-2], kf=kf, lost=sys_.frontend.lost_number,
                    est=sys_.frontend.estimated_trajectory(),
                    psnr=meta["metrics"].get("PSNR", float("nan")),
                    ms=statistics.median([1e3 * x for x in sys_.frame_s]),
                    fps=DISK_ENTRY_FRAMES / run_s)
    print(f"phase 11b entry point run_system.main {' '.join(argv[:-2])}: loader "
          f"{sys_.loader}{diff}; {DISK_ENTRY_FRAMES} frames, keyframes {kf}, lost "
          f"{sys_.frontend.lost_number}, ATE RMSE {ate:.5f} m, test PSNR "
          f"{meta['metrics'].get('PSNR', float('nan')):.2f} dB; {line}; "
          f"{frame_ms_line(sys_, DISK_ENTRY_FRAMES, run_s)} (model set-up and save included "
          f"in the seconds); idle share {win_b.idle():.3f} (11a {idle_a:.3f}) over frames "
          f"{SYS_PROFILED[0]}-{SYS_PROFILED[1] - 1}", flush=True)
    del sys_
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a TUM sequence at 640x480: SLAM 512x384 by INTER_AREA, map 320x240
    tum_ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=TUM_W),
                              n_frames=TUM_FRAMES, width=TUM_W, height=TUM_H)
    tum_root = tempfile.mkdtemp(prefix="chip_smoke_tum_")
    tum_calib = write_stream(tum_ds, tum_root, tum=True)
    argv = ["-s", tum_root, "-d", "tum", "--calib", tum_calib, "--downsampling", "2",
            "--max_size_slam", str(TUM_SLAM), "--oracle", "--test_hold", str(TUM_TEST_HOLD),
            "--retrieval_checkpoint_path", "", "-m", tempfile.mkdtemp(prefix="chip_smoke_tum_")]
    meta, sys_, run_s, launches["phase 11c"] = run_entry(argv)
    line = check_system_launches(sys_, launches["phase 11c"], "phase 11c")
    d = sys_.dataset
    check((d.W_slam, d.H_slam, d.W_map, d.H_map)
          == (TUM_SLAM, TUM_SLAM * 3 // 4, TUM_W // 2, TUM_H // 2),
          f"phase 11c: SLAM {d.W_slam}x{d.H_slam}, map {d.W_map}x{d.H_map}")
    check(sys_.loader == want_loader, f"phase 11c ran the {sys_.loader} loader")
    n_kf = len(sys_.keyframes)
    ate = meta["trajectory"]["APE"]["rmse"]
    check(sys_.frontend.lost_number == 0, f"phase 11c: {sys_.frontend.lost_number} lost")
    check(n_kf >= 2, f"phase 11c: {n_kf} keyframes")
    check(ate < 0.03, f"phase 11c: ATE RMSE {ate} m")
    dec = sys_.mapper.decode_s
    loaders = ""
    if NATIVE_PHASES:
        pf = native_loader.NativePrefetcher(d.image_paths, d.transform)
        ds_err, dm_err = [], []
        for i in range(8):
            slam, mp = pf.get()
            img = d[i][0]
            ds_err.append(np.abs(slam - d.transform.to_slam(img)))
            dm_err.append(np.abs(mp - d.transform.to_map(img)))
        pf.close()
        loaders = (f"; native against Python loader over 8 frames: SLAM mean "
                   f"{np.mean(ds_err):.3g} max {np.max(ds_err):.3g}, map mean "
                   f"{np.mean(dm_err):.3g} max {np.max(dm_err):.3g}")
    print(f"phase 11c TUM {TUM_W}x{TUM_H} -d tum --downsampling 2: loader {sys_.loader}"
          f"{loaders}; {TUM_FRAMES} frames, keyframes "
          f"{sys_.keyframes.dataset_idx[:n_kf].tolist()}, lost {sys_.frontend.lost_number}, "
          f"ATE RMSE {ate:.5f} m, test PSNR {meta['metrics'].get('PSNR', float('nan')):.2f} "
          f"dB; {line}; {frame_ms_line(sys_, TUM_FRAMES, run_s)}; the mapper decoded "
          f"{dec[1]} frames again on the worker thread, {1e3 * dec[0] / max(dec[1], 1):.1f} ms "
          f"each (decode + to_map); {host_decode_line(d)}", flush=True)
    del sys_
    gc.collect()
    torch.cuda.empty_cache()

    # (d) auto-calibration on the model path: no --calib, no --oracle
    argv = ["-s", root, "--model_size", MODEL_SIZE, "--test_hold", str(TEST_HOLD),
            "--max_size_slam", str(SYS_W), "--seq_length", str(CALIB_FRAMES),
            "--checkpoint_path", "",
            "--retrieval_checkpoint_path", "", "-m", tempfile.mkdtemp(prefix="chip_smoke_cal_")]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        meta, sys_, run_s, launches["phase 11d"] = run_entry(argv)
    line = check_system_launches(sys_, launches["phase 11d"], "phase 11d")
    cal = sys_.auto_calib
    check(cal is not None, "phase 11d: auto-calibration did not run")
    check(cal["applied"] or cal.get("error", "").startswith("degenerate focal estimate"),
          f"phase 11d: auto-calibration {cal}")
    warned = [str(w.message) for w in caught if "auto-calibration" in str(w.message)]
    print(f"phase 11d auto-calibration, run_system.main {' '.join(argv[:-2])}: guessed focal "
          f"{cal['guess']:.2f} px, estimate {cal['estimate']:.4g} px ("
          + ("applied" if cal["applied"] else f"not applied: {cal['error']}, reported")
          + f"), K_slam used {np.round(cal['K_slam'], 3).tolist()}; warnings {warned}; "
          f"{meta['n_frames']} frames in {run_s:.1f} s (model build included), loader "
          f"{sys_.loader}, lost {sys_.frontend.lost_number} (random weights); {line}",
          flush=True)
    del sys_
    gc.collect()
    torch.cuda.empty_cache()
    return launches, disk_ref


# ---------------------------------------------------------------------------
# Phase 12: the side models and the keypoint-SfM bootstrap
# ---------------------------------------------------------------------------

def chw(img_hwc) -> np.ndarray:
    """A uint8 (H, W, 3) frame as (3, H, W) float32 in [0, 1]."""
    return img_hwc.astype(np.float32).transpose(2, 0, 1) / 255.0


def same_keypoints(ka, sa, kb, tol: float) -> int:
    """Check that two detections hold the same keypoints, in the same order
    but for swaps of scores within ``tol`` of each other; returns the rows
    out of place (the CPU test's rule, tests/torch_parity.py)."""
    ka, kb, sa = (np.asarray(x) for x in (ka, kb, sa))
    check(sorted(map(tuple, ka.tolist())) == sorted(map(tuple, kb.tolist())),
          "the card's and the CPU's keypoints are different sets")
    pos = {tuple(k): i for i, k in enumerate(ka.tolist())}
    moved = [(i, pos[tuple(k)]) for i, k in enumerate(kb.tolist()) if pos[tuple(k)] != i]
    for i, j in moved:
        check(abs(float(sa[i]) - float(sa[j])) <= tol,
              f"keypoint rows {i} and {j} swapped between scores {sa[i]} and {sa[j]}")
    return len(moved)


def xfeat_phase(dev, img) -> str:
    """12a: XFeat's detector at top_k 4096 and 1024 and its dense variant
    at 512x384 on seeded random weights, against the port's own CPU run of
    the same weights and frame: the same keypoints (but for swaps of
    near-tied scores), descriptors within 1e-4, scores within 1e-5."""
    import copy

    import torch
    from artdeco_tpu_torch.models import xfeat as TX

    cpu = torch.device("cpu")
    parts = []
    x_dev = torch.as_tensor(img, device=dev)[None]
    for top_k in XFEAT_TOPK:
        cfg = TX.sparse_config(top_k=top_k)
        fn = TX.make_detector(top_k=top_k, device=dev, seed=SEED)
        k, f, s = (a.cpu().numpy() for a in fn(img))
        ms = cuda_ms(lambda: TX.detect_and_compute(fn.model, x_dev, cfg), n=10)
        ck, cf, cs = (a.numpy() for a in TX.detect_and_compute(
            copy.deepcopy(fn.model).to(cpu), torch.as_tensor(img)[None], cfg))
        moved = same_keypoints(ck, cs, k, 1e-5)
        pos = {tuple(r): i for i, r in enumerate(ck.tolist())}
        order = np.asarray([pos[tuple(r)] for r in k.tolist()])
        f_err, s_err = np.abs(f - cf[order]).max(), np.abs(s - cs[order]).max()
        check(f_err <= 1e-4 and s_err <= 1e-5,
              f"XFeat top_k {top_k}: descriptors {f_err:.3g}, scores {s_err:.3g} from the CPU's")
        parts.append(f"top_k {top_k}: {ms:.3f} ms, {int((s > 0).sum())} keypoints scoring > 0, "
                     f"equal to the CPU's ({moved} rows swapped between near-tied scores; "
                     f"descriptors within {f_err:.3g}, scores within {s_err:.3g})")
        if top_k == XFEAT_TOPK[0]:
            parts.append("profile: " + profile_window(
                lambda: TX.detect_and_compute(fn.model, x_dev, cfg), 1, "calls"))
    dense = TX.make_dense_fn(device=dev, seed=SEED)
    out = TX.dense_features(dense.model, x_dev)
    ms = cuda_ms(lambda: TX.dense_features(dense.model, x_dev), n=10)
    want = (1, img.shape[1] // 32 * 8, img.shape[2] // 32 * 8, 64)
    check(tuple(out.shape) == want and bool(out.isfinite().all()),
          f"dense features {tuple(out.shape)}")
    parts.append(f"dense_features {ms:.3f} ms -> {tuple(out.shape)}")
    return "; ".join(parts)


def dav2_phase(dev, img) -> str:
    """12b: DepthAnythingV2 at ``dav2_config(DAV2_ENCODER)`` width on seeded
    random weights through ``MonoDepthEstimator``: a 512x384 frame, 392x518
    into the net.  Finite, non-negative inverse depth of the frame's shape."""
    import torch
    from artdeco_tpu_torch.mapper.mono_depth import MonoDepthEstimator
    from artdeco_tpu_torch.models.depth_anything import make_dav2_model_fn

    fn = make_dav2_model_fn(encoder=DAV2_ENCODER, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in fn.model.parameters())
    est = MonoDepthEstimator(fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30      # the weights and earlier phases' tensors
    t0 = time.time()
    idepth, conf = est(img)
    call_ms = 1e3 * (time.time() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(idepth.shape == img.shape[1:] and np.isfinite(idepth).all()
          and (idepth >= 0).all() and np.isfinite(conf).all(),
          f"mono depth {idepth.shape}, finite {np.isfinite(idepth).all()}, min {idepth.min()}")
    h, w = img.shape[1:]
    nh, nw = (max(int(round(a * 518 / max(h, w) / 14)), 1) * 14 for a in (h, w))
    x = torch.zeros(1, 3, nh, nw, device=dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: fn.model(x), n=5)
    del fn, est
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{DAV2_ENCODER}, {n_params / 1e6:.1f} M parameters: forward at {nh}x{nw} "
            f"{ms:.2f} ms (device); MonoDepthEstimator call {call_ms:.1f} ms (host clock, "
            f"with the resizes, the copy back and the confidence); peak {peak:.2f} GiB, "
            f"{peak - held:.2f} above the {held:.2f} held before the call; "
            f"inverse depth {idepth.shape} in [{idepth.min():.3g}, {idepth.max():.3g}]")


def bootstrap_stages(pi, frames) -> dict:
    """The bootstrap's stages one by one, as ``bootstrap`` runs them, each
    timed to the device's end: ms of the detection of all frames, the
    match, RANSAC and triangulation."""
    import torch
    from artdeco_tpu_torch.poses.matcher import match_described
    from artdeco_tpu_torch.poses.triangulator import triangulate

    sync = torch.cuda.synchronize
    ms = {}
    t0 = time.time()
    dks = [pi.detect(f) for f in frames]
    sync()
    ms["detect"] = 1e3 * (time.time() - t0)
    t0 = time.time()
    m = match_described(dks[0], dks[-1], min_sim=0.7)
    sync()
    ms["match"] = 1e3 * (time.time() - t0)
    t0 = time.time()
    _, inl, _ = pi.ransac.estimate(dks[0].kpts[m.idx], m.kpts_other)
    sync()
    ms["ransac"] = 1e3 * (time.time() - t0)
    Rt1 = torch.eye(4, device=pi.device)
    Rt1[0, 3] = 0.1
    t0 = time.time()
    triangulate(dks[0].kpts[m.idx][inl], m.kpts_other[inl][None], torch.eye(4, device=pi.device),
                Rt1[None], torch.tensor(pi.f, device=pi.device), pi.centre, max_error=5e-2,
                min_dis=1e-6)
    sync()
    ms["triangulate"] = 1e3 * (time.time() - t0)
    return ms


def near_tie_matches(pi, cpu, frames) -> tuple:
    """The bootstrap's match of the first and the last frame on the card
    and on the CPU: each frame's keypoints must agree (but for swaps of
    near-tied scores), and a match that only one device makes must be a
    near-tie there, a frame-0 keypoint whose two most similar candidates
    differ by less than 1e-6 in cosine similarity.  Returns (the matches
    that differ, the largest such gap)."""
    import torch
    from artdeco_tpu_torch.poses.matcher import match_described

    dks = [[p.detect(frames[i]) for i in (0, -1)] for p in (pi, cpu)]
    for a, b in zip(dks[0], dks[1]):
        same_keypoints(b.kpts.numpy(), b.scores.numpy(), a.kpts.cpu().numpy(), 1e-9)
    pairs = []
    for d0, d1 in dks:
        m = match_described(d0, d1, min_sim=0.7)
        # frame-0 keypoints by position, so that a swapped row still matches
        pairs.append({(tuple(d0.kpts[i].tolist()), tuple(m.kpts_other[j].tolist()))
                      for j, i in enumerate(m.idx.tolist())})
    diff = pairs[0] ^ pairs[1]
    d0, d1 = dks[1]
    sim = (d0.desc @ d1.desc.T).double()
    rows = {tuple(k): i for i, k in enumerate(d0.kpts.tolist())}
    gaps = []
    for k0, _ in diff:
        top2 = torch.topk(sim[rows[k0]], 2).values
        gaps.append(float(top2[0] - top2[1]))
    check(all(g < 1e-6 for g in gaps), f"matches differ away from near-ties: gaps {gaps}")
    return len(diff), max(gaps, default=0.0)


def bootstrap_phase(dev, frames) -> str:
    """12c: ``PoseInitializer.bootstrap`` as users call it, on frames 0..8
    of the 512x384 stream, against the port's CPU run of the same frames.
    The JAX package gives False there (689 matches, 522 inliers, no point
    in front of both cameras at its fixed baseline guess), and so must the
    port on both devices.  The counts must be the CPU's but for matches
    decided by a near-tie (``near_tie_matches``): the first row's
    zero-score keypoints carry clamped patches that nearly repeat, and
    the card's sums, in another order, may pick the other of two
    candidates 1e-7 apart."""
    import torch
    from artdeco_tpu_torch.poses.pose_initializer import PoseInitializer

    h, w = frames[0].shape[1:]
    pi = PoseInitializer(f=0.8 * w, centre=(w / 2, h / 2), device=dev)
    t0 = time.time()
    ok = pi.bootstrap(frames)
    torch.cuda.synchronize()
    boot_ms = 1e3 * (time.time() - t0)
    cpu = PoseInitializer(f=0.8 * w, centre=(w / 2, h / 2), device=torch.device("cpu"))
    cpu_ok = cpu.bootstrap(frames)
    check(ok is cpu_ok is False, f"bootstrap {ok} on the card, {cpu_ok} on the CPU, not False")
    n_diff, gap = near_tie_matches(pi, cpu, frames)
    for k in ("matches", "inliers"):
        check(abs(pi.stats[k] - cpu.stats[k]) <= n_diff,
              f"bootstrap {k}: {pi.stats[k]} on the card, {cpu.stats[k]} on the CPU, "
              f"{n_diff} matches decided by near-ties")
    check(pi.stats["triangulated"] == cpu.stats["triangulated"],
          f"triangulated {pi.stats['triangulated']} on the card, {cpu.stats['triangulated']} "
          f"on the CPU")
    stages = bootstrap_stages(pi, frames)
    return (f"{len(frames)} frames: result {ok}; {pi.stats['matches']} matches, "
            f"{pi.stats['inliers']} RANSAC inliers, {pi.stats['triangulated']} triangulated; "
            f"the CPU's {cpu.stats['matches']} / {cpu.stats['inliers']} / "
            f"{cpu.stats['triangulated']} ({n_diff} matches differ, each a near-tie: "
            f"similarity gap <= {gap:.3g}); bootstrap {boot_ms:.1f} ms; stages: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()))


def solver_scene(n: int, seed: int = 0):
    """``tests/test_poses.py``'s two-view scene with ``n`` points (f 100,
    centre (64, 48)): points, both views' pixels, the second camera's R, t."""
    import torch
    from artdeco_tpu_torch.geometry import lie

    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3) * np.array([1.0, 0.8, 0.5]) + np.array([0, 0, 4.0])
    T2 = lie.sim3_exp(torch.tensor([0.3, 0.05, 0.02, 0.03, -0.04, 0.02, 0.0]))
    R2 = lie.quat_to_matrix(T2[3:7]).double().numpy()
    t2 = T2[:3].double().numpy()

    def proj(Xc):
        return 100.0 * Xc[:, :2] / Xc[:, 2:3] + np.array([64.0, 48.0])

    return X, proj(X), proj(X @ R2.T + t2), R2, t2


def solvers_phase(dev) -> str:
    """12d: ``mini_ba`` (2 cameras, ``optimize_pts``, 40 iterations) and
    ``opt_pnp`` on a seeded 1024-point scene, against the scene's truth,
    with the CPU tests' tolerances (tests/test_torch_poses.py): the
    relative rotation and the translation's direction within 1e-5 after
    mini-BA, the PnP pose within 1e-3 in the Sim(3) log."""
    import torch
    from artdeco_tpu_torch.geometry import lie
    from artdeco_tpu_torch.mapper.keyframe import sixd_to_mtx
    from artdeco_tpu_torch.poses.mini_ba import mini_ba
    from artdeco_tpu_torch.poses.pnp import opt_pnp

    X, uv1, uv2, R2, t2 = solver_scene(SOLVER_POINTS)
    rng = np.random.RandomState(1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)   # noqa: E731
    R6D0 = f32(np.stack([np.eye(3)[:, :2], R2[:, :2] + 0.02 * rng.randn(3, 2)]))
    t0_ = f32(np.stack([np.zeros(3), t2 + [0.05, -0.03, 0.04]]))
    centre = f32([64.0, 48.0])
    args = (R6D0, t0_, f32(X), f32(np.stack([uv1, uv2])),
            torch.ones(2, len(X), dtype=torch.bool, device=dev), f32(100.0), centre)
    torch.cuda.synchronize()
    t0 = time.time()
    R6D, t, _, _, cost = mini_ba(*args, iters=40, optimize_pts=True)
    torch.cuda.synchronize()
    ba_ms = 1e3 * (time.time() - t0)
    prof = profile_window(lambda: mini_ba(*args, iters=2, optimize_pts=True), 2, "iterations")
    R = sixd_to_mtx(R6D).double().cpu().numpy()
    tt = t.double().cpu().numpy()
    Rr = R[1] @ R[0].T
    tr = tt[1] - Rr @ tt[0]
    r_err = np.abs(Rr - R2).max()
    t_err = np.abs(tr / np.linalg.norm(tr) - t2 / np.linalg.norm(t2)).max()
    check(r_err <= 1e-5 and t_err <= 1e-5,
          f"mini-BA: relative rotation {r_err:.3g}, translation direction {t_err:.3g} off")

    T_gt = torch.cat([torch.as_tensor(t2, dtype=torch.float32),
                      lie.matrix_to_quat(torch.as_tensor(R2, dtype=torch.float32))])
    xi = torch.tensor([0.1, -0.05, 0.08, 0.05, -0.03, 0.06, 0.0])
    T0 = lie.sim3_mul(lie.sim3_exp(xi), torch.cat([T_gt, torch.ones(1)]))[:7]
    K = f32([[100.0, 0, 64.0], [0, 100.0, 48.0], [0, 0, 1]])
    pargs = (T0.to(dev)[None], f32(X)[None], f32(uv2)[None],
             torch.ones(1, len(X), dtype=torch.bool, device=dev), K)
    T_out, _ = opt_pnp(*pargs, iters=25)
    pnp_ms = cuda_ms(lambda: opt_pnp(*pargs, iters=25), n=5)
    rel = lie.sim3_mul(lie.sim3_inv(torch.cat([T_out[0].cpu(), torch.ones(1)])),
                       torch.cat([T_gt, torch.ones(1)]))
    p_err = float(torch.linalg.vector_norm(lie.sim3_log(rel)[:6]))
    check(p_err < 1e-3, f"PnP pose {p_err:.3g} off in the Sim(3) log")
    dim = 18 + 3 * SOLVER_POINTS
    return (f"mini-BA over {SOLVER_POINTS} points ({dim} unknowns, Jacobian "
            f"{6 * SOLVER_POINTS}x{dim}), 40 iterations: {ba_ms:.0f} ms (host clock), cost "
            f"{float(cost):.3g}, relative rotation {r_err:.3g} and translation direction "
            f"{t_err:.3g} from the truth (profile: {prof}); PnP over {SOLVER_POINTS} points, "
            f"25 iterations: {pnp_ms:.2f} ms, pose {p_err:.3g} from the truth")


def knn_phase(dev) -> str:
    """12e: ``knn_mean_sq_dist(k=3, window=16)`` on a seeded 10^5-point
    cloud: within 1e-6 relative of the port's CPU result; beside it the
    exact 3-NN mean by brute force on the card (``torch.cdist`` in chunks,
    a check only), and the share of points where the approximation
    differs from it."""
    import torch
    from artdeco_tpu_torch.ops.knn import knn_mean_sq_dist

    rng = np.random.RandomState(SEED)
    xyz = (rng.randn(KNN_POINTS, 3) * [2.0, 1.0, 0.5]).astype(np.float32)
    x = torch.as_tensor(xyz, device=dev)
    got = knn_mean_sq_dist(x)
    ms = cuda_ms(lambda: knn_mean_sq_dist(x), n=10)
    ref = knn_mean_sq_dist(torch.as_tensor(xyz)).numpy()
    g = got.cpu().numpy()
    rel = np.abs(g - ref) / np.maximum(np.abs(ref), 1e-30)
    check(rel.max() <= 1e-6, f"knn: {rel.max():.3g} relative from the CPU's")
    exact = torch.empty(KNN_POINTS, device=dev)
    for c0 in range(0, KNN_POINTS, 4096):
        d = torch.cdist(x[c0:c0 + 4096], x) ** 2
        d[torch.arange(d.shape[0], device=dev), torch.arange(c0, c0 + d.shape[0], device=dev)] = \
            torch.inf
        exact[c0:c0 + 4096] = torch.topk(d, 3, dim=1, largest=False).values.mean(dim=1)
    e = exact.cpu().numpy()
    differs = np.abs(g - e) > 1e-4 * np.abs(e) + 1e-9
    prof = profile_window(lambda: knn_mean_sq_dist(x), 1, "calls")
    return (f"{KNN_POINTS} points, k 3, window 16: {ms:.3f} ms (profile: {prof}), within {rel.max():.3g} "
            f"relative of the CPU's; differs from the exact 3-NN mean on "
            f"{differs.mean():.4f} of the points (median ratio approximate / exact "
            f"{np.median(g / np.maximum(e, 1e-30)):.3f})")


def k3_f32_phase(dev, tcfg, tds) -> tuple:
    """12f: K3's f32 instance.  Its launch shape; against its plain version
    at the stream shape (384x512, 24 f32 channels, radius 4, dilations
    5..1, every query refined as the JAX f32 search does), positions and
    scores bitwise; its time beside bf16 K3's.  Then the tracking frontend
    over the stream's first ``F32_TRACK_FRAMES`` frames with
    ``matching.refine_dtype: null``, as a user sets it: each tracked
    frame's match launches the f32 instance once and bf16 K3 never, no
    frame is lost.  Returns (summary, the golden's numbers, launches)."""
    import torch
    from artdeco_tpu_torch import kernels
    from artdeco_tpu_torch.models.oracle import OracleRunner
    from artdeco_tpu_torch.ops import matching as M
    from artdeco_tpu_torch.ops import refine_dense as RD
    from artdeco_tpu_torch.vslam.frontend import Frontend
    from artdeco_tpu_torch.vslam.keyframes import KeyframeStore

    h, w = tds.H_slam, tds.W_slam
    mcfg = dict(tcfg["matching"], refine_dtype=None)
    runner = OracleRunner((h, w), tds.K_slam, mcfg, device=dev)
    frames = [tds[i] for i in range(F32_TRACK_FRAMES)]
    for i in range(F32_TRACK_FRAMES):
        T = np.ones(8, np.float32)
        T[:7] = tds.Twc_gt[i]
        runner.register(tds.transform.to_slam(frames[i][0]), i, T)
    X11 = runner._dev(1)[0].reshape(1, h, w, 3)
    X21 = runner._cross_dev(0, 1).reshape(1, h, w, 3)
    p1, _ = M.project_matches(X11, X21, None, max_iter=int(mcfg["max_iter"]),
                              lambda_init=float(mcfg["lambda_init"]),
                              cost_thresh=float(mcfg["convergence_thresh"]),
                              dist_thresh=float(mcfg["dist_thresh"]))
    D11 = runner._dev(1)[1].reshape(h, w, -1)
    D21 = runner._dev(0)[1]
    check(D11.dtype == D21.dtype == torch.float32, "oracle descriptors are not float32")
    valid = torch.ones(h * w, dtype=torch.bool, device=dev)
    args = (D11.contiguous(), D21.contiguous(), p1[0].contiguous(), valid, K3_RADIUS,
            K3_DILATION)
    pk, sk = RD.window_argmax(*args)
    pp, sp = RD.window_argmax_plain(*args, 1, RD.FLT_MIN)
    torch.cuda.synchronize()
    same = 1.0 - (pk != pp).any(-1).float().mean().item()
    err = (sk - sp).abs().max().item()
    check(torch.equal(pk, pp), f"K3 f32 positions equal on {same:.6f} of the queries, not all")
    check(torch.equal(sk.view(torch.int32), sp.view(torch.int32)),
          f"K3 f32 scores not bitwise equal (max difference {err:.3g})")
    ms = cuda_ms(lambda: RD.window_argmax(*args))
    plain_ms = cuda_ms(lambda: RD.window_argmax_plain(*args, 1, RD.FLT_MIN))
    bf16_args = (D11.to(torch.bfloat16), D21.to(torch.bfloat16)) + args[2:]
    bf16_ms = cuda_ms(lambda: RD.window_argmax(*bf16_args))
    nq, nf = h * w, D11.shape[-1]
    # the f32 products are not tensor-core work: 2 flops a channel and
    # window position of every query at the float32 rate; f32 descriptors
    # read once, positions and scores written once
    k3_bound, k3_by = bound(2 * nf * K3_WINDOW * nq,
                            4 * h * w * nf + 4 * nq * nf + 8 * nq + nq + 8 * nq + 4 * nq)
    shape = launch_shape(kernels.launch_info("artdeco_refine_f32_info", K3_RADIUS),
                         -(-nq // 256), f"{w}x{h}")

    store = KeyframeStore(h, w, tds.K_slam, buffer=16, device=dev)
    fe = Frontend(types.SimpleNamespace(), tcfg, tds, store, runner, device=dev)
    reset_launches()
    for img, info in frames:
        fe.process_frame(img, info)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["k3_f32"] == F32_TRACK_FRAMES - 1 and launches["k3"] == 0,
          f"f32 tracking launched K3 f32 {launches['k3_f32']}, bf16 {launches['k3']} times "
          f"over {F32_TRACK_FRAMES - 1} matches")
    check(fe.lost_number == 0, f"f32 tracking lost {fe.lost_number} frames")
    summary = (f"launch shape {shape}; stream shape {h}x{w} f{nf} r{K3_RADIUS} d{K3_DILATION} "
               f"({nq} queries) positions equal {same:.6f}, max score err {err:.3g}, K3 f32 "
               f"{ms:.4f} ms (bound {k3_bound:.4f} ms by {k3_by}, {k3_bound / ms:.1%} of it; "
               f"plain {plain_ms:.3f} ms; bf16 K3 on the same inputs {bf16_ms:.4f} ms); "
               f"tracking {F32_TRACK_FRAMES} frames with refine_dtype null: K3 f32 launches "
               f"{launches['k3_f32']}, bf16 {launches['k3']}, lost {fe.lost_number}, keyframes "
               f"{len(store)}")
    golden = dict(err=err, ms=ms, plain_ms=plain_ms, bound=k3_bound, by=k3_by)
    return summary, golden, launches["k3_f32"]


def side_models_phase(dev, tcfg, tds) -> tuple:
    """Phase 12 (see the module docstring).  Returns K3 f32's golden numbers
    and its launches on 12f's tracking run."""
    frames = [chw(tds[i][0]) for i in range(BOOT_FRAMES)]
    t0 = time.time()
    print(f"phase 12a XFeat: {xfeat_phase(dev, frames[0])}", flush=True)
    print(f"phase 12b DepthAnythingV2: {dav2_phase(dev, frames[0])}", flush=True)
    print(f"phase 12c bootstrap: {bootstrap_phase(dev, frames)}", flush=True)
    print(f"phase 12d solvers: {solvers_phase(dev)}", flush=True)
    print(f"phase 12e knn: {knn_phase(dev)}", flush=True)
    summary, golden, launches = k3_f32_phase(dev, tcfg, tds)
    print(f"phase 12f K3 f32: {summary}", flush=True)
    print(f"phase 12 took {time.time() - t0:.1f} s", flush=True)
    return golden, launches


def moved(obj, device):
    """A copy of a state tree (tensors in dataclasses, dicts and named
    tuples) on ``device``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: moved(getattr(obj, f.name), device)
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(moved(x, device) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(moved(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    return obj


def random_scene(dev, n: int, seed: int = 3):
    """A ``SceneModel`` (``MapperConfig()``, 512x384) holding ``n`` random
    active Gaussians in front of keyframe 0's camera (the identity pose):
    depths 1.5-4, scales 3-30 mm, random rotations, opacities, colours,
    features and clusters."""
    import torch
    from artdeco_tpu_torch.mapper import gaussians as G
    from artdeco_tpu_torch.mapper import keyframe as KF
    from artdeco_tpu_torch.mapper.config import MapperConfig
    from artdeco_tpu_torch.mapper.scene_model import SceneModel

    cfg = MapperConfig()
    f = 0.8 * SYS_W
    K = np.asarray([[f, 0, SYS_W / 2], [0, f, SYS_H / 2], [0, 0, 1]], np.float32)
    sm = SceneModel(SYS_W, SYS_H, K, cfg, device=dev, seed=seed)
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    z = 1.5 + 2.5 * u(n)
    slab = G.create_slab(n, cfg.sh_degree, cfg.local_feat_dim, cfg.position_lr_init, "cpu")
    slab = dataclasses.replace(
        slab, active=torch.ones(n, dtype=torch.bool),
        cls_id=torch.randint(0, cfg.cluster_capacity, (n,), generator=g, dtype=torch.int32),
        xyz=torch.stack([(u(n) * 2 - 1) * 0.7 * z, (u(n) * 2 - 1) * 0.5 * z, z], -1),
        f_dc=u(n, 1, 3) * 2 - 1, f_rest=0.1 * torch.randn(slab.f_rest.shape, generator=g),
        scaling=torch.log(0.003 + 0.027 * u(n, 3)), rotation=torch.randn(n, 4, generator=g),
        opacity=torch.randn(n, 1, generator=g),
        local_feat=0.3 * torch.randn(slab.local_feat.shape, generator=g))
    sm.slab = moved(slab, dev)
    sm.opt = G.create_opt_state(sm.slab)
    sm._train_len = n
    sm.gfeat.val.copy_(0.3 * torch.randn(sm.gfeat.val.shape, generator=g))
    KF.set_keyframe(sm.pool, 0, torch.eye(4, device=dev), torch.eye(3, 4, device=dev),
                    0.0, 0.0, 0.0, False)
    return sm


def strip_render_line(sm, mesh, kf: int, what: str) -> str:
    """Phase 13a on one scene: ``render_from_id`` (render_core) and
    ``render_sharded`` (raw splats) in row strips over ``mesh`` against the
    single-device render of the same view (RGB within 3e-5, visibility
    equal, one K1 launch a strip), and their device ms.  Leaves ``mesh``
    enabled on ``sm``."""
    import torch
    from artdeco_tpu_torch.mapper import keyframe as KF
    from artdeco_tpu_torch.ops.splat import api

    n = mesh.size
    sm.enable_mesh(None)
    single = sm.render_from_id(kf)
    s = sm.slab
    raw = (s.xyz, s.rotation, torch.exp(s.scaling), torch.sigmoid(s.opacity[:, 0]),
           torch.cat([s.f_dc, s.f_rest], 1), KF.get_Rt(sm.pool, kf), sm._K_at_lvl(0))
    raw_single, raw_alpha, _ = api.rasterization(
        *raw, sm.width, sm.height, sh_degree=sm.cfg.sh_degree,
        eps2d=sm.cfg.low_pass_filter_eps, valid_mask=s.active)
    single_ms = cuda_ms(lambda: sm.render_from_id(kf), MESH_TIMED)
    raw_single_ms = cuda_ms(lambda: api.rasterization(
        *raw, sm.width, sm.height, sh_degree=sm.cfg.sh_degree,
        eps2d=sm.cfg.low_pass_filter_eps, valid_mask=s.active), MESH_TIMED)
    sm.enable_mesh(mesh)
    reset_launches()
    sharded = sm.render_from_id(kf)
    torch.cuda.synchronize()
    k1_core = read_launches()["fwd"]
    reset_launches()
    raw_render, raw_sh_alpha = sm.render_sharded(kf)
    torch.cuda.synchronize()
    k1_raw = read_launches()["fwd"]
    check(k1_core == n and k1_raw == n,
          f"13a {what}: K1 launches {k1_core} / {k1_raw} for {n} strips")
    sharded_ms = cuda_ms(lambda: sm.render_from_id(kf), MESH_TIMED)
    raw_ms = cuda_ms(lambda: sm.render_sharded(kf), MESH_TIMED)
    err = float((sharded["render"] - single["render"]).abs().max())
    err_id = float((sharded["invdepth"] - single["invdepth"]).abs().max())
    d, dr = sharded["depth"], single["depth"]
    depth_ok = bool(((d - dr).abs() <= 1e-3 * dr.abs() + 1e-5).all())
    err_raw = float((raw_render[..., :3] - raw_single[..., :3]).abs().max())
    err_raw_a = float((raw_sh_alpha - raw_alpha).abs().max())
    vis_eq = bool(torch.equal(sharded["visibility"], single["visibility"]))
    gvis_eq = bool(torch.equal(sharded["global_visibility"], single["global_visibility"]))
    check(err <= 3e-5 and err_raw <= 3e-5, f"13a {what}: strips RGB {err} / raw {err_raw} "
          "from the single render")
    check(depth_ok, f"13a {what}: strips depth beyond 1e-3 relative of the single render")
    check(vis_eq and gvis_eq, f"13a {what}: visibility differs from the single render")
    return (f"{what}: {n} strips of {sm.height // n} rows at {sm.width}x{sm.height}, "
            f"{int(single['visibility'].sum())} visible Gaussians; render_from_id RGB max "
            f"diff {err:.3g}, depth within 1e-3 relative (invdepth max diff {err_id:.3g}), "
            f"visibility and cluster visibility equal; "
            f"render_sharded RGB {err_raw:.3g}, alpha {err_raw_a:.3g}; K1 launches {k1_core} a "
            f"render; device ms: render_from_id {sharded_ms:.3f} sharded vs {single_ms:.3f} "
            f"single, raw {raw_ms:.3f} sharded vs {raw_single_ms:.3f} single")


def dp_close(out, ref, before, cfg) -> dict:
    """A dp step's outputs ``out`` against ``ref`` (the same step on another
    device) from the state ``before``, at the CPU parity test's tolerances
    (``tests/test_torch_parallel.py``): loss rtol 1e-5; gradients, read from
    the first Adam moment, within 1e-4 of each group's largest; parameters
    whose gradient that check resolves within atol 2e-5 / rtol 1e-4, the
    others within one Adam step; the pool's rows likewise; ``mlp_lr``
    exact.  Returns the largest differences."""
    from artdeco_tpu_torch.mapper import gaussians as G
    from artdeco_tpu_torch.mapper.scene_model import MLP_KEYS

    a = [moved(x, "cpu") for x in out]
    b = [moved(x, "cpu") for x in ref]
    s0 = [moved(x, "cpu") for x in before]
    b1 = cfg.adam_b1
    full = (1 - b1) / np.sqrt(1 - cfg.adam_b2)
    lrs = dict(xyz=cfg.position_lr_init, f_dc=cfg.feature_lr, f_rest=cfg.feature_lr / 20.0,
               scaling=cfg.scaling_lr, rotation=cfg.rotation_lr, opacity=cfg.opacity_lr,
               local_feat=cfg.feat_lr)
    groups = [(k, getattr(a[0], k), getattr(b[0], k), a[1][k].exp_avg, b[1][k].exp_avg,
               s0[1][k].exp_avg, lrs[k]) for k in G.TRAINED_KEYS]
    groups.append(("gfeat", a[2].val, b[2].val, a[2].opt.exp_avg, b[2].opt.exp_avg,
                   s0[2].opt.exp_avg, cfg.feat_lr))
    groups += [("mlp." + k, getattr(a[3], k), getattr(b[3], k), a[4][k].exp_avg,
                b[4][k].exp_avg, s0[4][k].exp_avg, float(s0[5])) for k in MLP_KEYS]
    worst = dict(loss=abs(float(a[7]["loss"]) / float(b[7]["loss"]) - 1), grad=0.0, param=0.0,
                 pool=0.0)
    check(worst["loss"] <= 1e-5, f"13b loss {float(a[7]['loss'])} vs {float(b[7]['loss'])}")
    check(float(a[5]) == float(b[5]), f"13b mlp_lr {float(a[5])} vs {float(b[5])}")
    for k, pa, pb, ma, mb, m0, lr in groups:
        ga, gb = (ma - b1 * m0) / (1 - b1), (mb - b1 * m0) / (1 - b1)
        scale = max(float(gb.abs().max()), 1e-30)
        e = float((ga - gb).abs().max())
        check(e <= 1e-4 * scale, f"13b {k} gradient {e} > 1e-4 * {scale}")
        worst["grad"] = max(worst["grad"], e / scale)
        resolved = gb.abs() > 1e-4 * scale
        d = (pa - pb).abs()
        ok = d <= 2e-5 + 1e-4 * pb.abs()
        check(bool(ok[resolved].all()), f"13b {k}: {int((~ok & resolved).sum())} parameters "
              f"beyond atol 2e-5 / rtol 1e-4, max {float(d[resolved].max())}")
        check(bool((d[~resolved] <= lr * full).all()), f"13b {k} beyond one Adam step")
        worst["param"] = max(worst["param"], float(d[resolved].max()) if resolved.any() else 0)
    for f in ("r_w2c", "t_w2c", "exposure", "depth_loss_weight"):
        pa, pb = getattr(a[6], f), getattr(b[6], f)
        d = float((pa - pb).abs().max())
        check(bool(((pa - pb).abs() <= 2e-5 + 1e-4 * pb.abs()).all()), f"13b pool {f}: {d}")
        worst["pool"] = max(worst["pool"], d)
    for f in ("opt_r", "opt_t", "opt_e"):
        for xa, xb in zip(getattr(a[6], f), getattr(b[6], f)):
            e = float((xa - xb).abs().max())
            check(e <= 1e-4 * max(float(xb.abs().max()), 1e-30), f"13b pool {f}: {e}")
    return worst


def dp_step_line(sm, mesh, dev) -> str:
    """Phase 13b: one dp step over ``mesh`` at the training level on
    ``sm``'s state, keyframes [a, b, b, test] (distinct, duplicated, a test
    frame; the first len(mesh) of them), against the same step on the CPU
    (``dp_close``); K1 and K2 launch once a slot; the ms of the dp step and
    of a one-slot step on the same state, keyframes per second, and the
    replica copy."""
    import torch
    from artdeco_tpu_torch.parallel.dp import make_dp_train_step, replicate_scene
    from artdeco_tpu_torch.parallel.mesh import Mesh

    n = mesh.size
    kfs = [i for i, kf in enumerate(sm.keyframes) if kf is not None]
    train = [i for i in kfs if not sm.keyframes[i].is_test]
    tests = [i for i in kfs if sm.keyframes[i].is_test]
    check(len(train) >= 2 and tests, f"13b: keyframes {train} and test frames {tests}")
    ids = [train[-1], train[-2], train[-2], tests[-1]][:n]
    lvl = sm.keyframes[ids[0]].pyr_lvl
    w, h = sm.width >> lvl, sm.height >> lvl
    gts, monos = zip(*[sm._device_kf(i, lvl) for i in ids])
    bg = torch.as_tensor(np.random.RandomState(SEED).rand(n, 3).astype(np.float32), device=dev)
    flags = [bool(sm.keyframes[i].is_test) for i in ids]
    state = (sm.slab, sm.opt, sm.gfeat, sm.mlp, sm.mlp_opt, sm.mlp_lr, sm.pool)
    K = sm._K_at_lvl(lvl)
    step = make_dp_train_step(mesh, sm.cfg, w, h)
    torch.cuda.synchronize()
    reset_launches()
    out = step(*state, ids, gts, monos, K, bg, is_test=flags)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["fwd"] == n and launches["bwd"] == n,
          f"13b: K1 {launches['fwd']} K2 {launches['bwd']} launches for {n} slots")
    cpu = torch.device("cpu")
    t0 = time.time()
    ref = make_dp_train_step(Mesh([cpu] * n), sm.cfg, w, h)(
        *moved(state, cpu), ids, moved(list(gts), cpu), moved(list(monos), cpu),
        K.cpu(), bg.cpu(), is_test=flags)
    cpu_s = time.time() - t0
    worst = dp_close(out, ref, state, sm.cfg)

    def host_ms(fn):
        fn()
        times = []
        for _ in range(MESH_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    dp_ms = host_ms(lambda: step(*state, ids, gts, monos, K, bg, is_test=flags))
    one = make_dp_train_step(Mesh([mesh.home]), sm.cfg, w, h)
    one_ms = host_ms(lambda: one(*state, ids[:1], gts[:1], monos[:1], K, bg[:1],
                                 is_test=flags[:1]))
    copy_ms = cuda_ms(lambda: [replicate_scene(mesh, d, sm.slab, sm.gfeat.val, sm.mlp)
                               for d in range(1, n)], MESH_TIMED)
    rep_mib = sum(x.nbytes for x in (*(getattr(sm.slab, f.name) for f in
                                       dataclasses.fields(sm.slab)), sm.gfeat.val,
                                     *(getattr(sm.mlp, k) for k in ("w1", "b1", "w2", "b2"))))
    return (f"{n} slots at {w}x{h}, keyframes {ids} (test flags {flags}), slab of "
            f"{sm.slab.capacity} rows ({sm.n_active_gaussians} active); launches K1 "
            f"{launches['fwd']} K2 {launches['bwd']}; card vs CPU (the CPU step {cpu_s:.1f} s): "
            f"loss rel {worst['loss']:.3g}, gradients {worst['grad']:.3g} of each group's "
            f"largest, resolved parameters {worst['param']:.3g}, pool rows {worst['pool']:.3g}, "
            f"mlp_lr equal; {dp_ms:.2f} ms a dp step ({n / dp_ms * 1e3:.1f} keyframes/s) vs "
            f"{one_ms:.2f} ms a one-slot step ({1e3 / one_ms:.1f} keyframes/s) on the same "
            f"state; replica copy {copy_ms:.3f} ms device time for {n - 1} replicas of "
            f"{rep_mib / 2**20:.1f} MiB")


def dryrun_gn_problem():
    """``__graft_entry__._dryrun_gn_sharded``'s problem: 16 poses viewing
    one smooth depth field at 32x24 through identity matches, 64 edges,
    free poses perturbed by 2 cm.  numpy (T, Xs, Cs, K, ii, jj, idx, vm,
    Q, ev, used), h, w."""
    P, E, h, w = 16, 64, 24, 32
    HW = h * w
    rng = np.random.RandomState(3)
    f = 40.0
    K = np.asarray([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = 2.0 + 0.3 * np.sin(u / 6.0) * np.cos(v / 5.0)
    pm = np.stack([(u - w / 2) / f * z, (v - h / 2) / f * z, z], -1).reshape(HW, 3)
    Xs = np.broadcast_to(pm.astype(np.float32), (P, HW, 3)).copy()
    T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (P, 1))
    T[1:, :3] = 0.02 * rng.randn(P - 1, 3)
    ii = np.repeat(np.arange(P, dtype=np.int32), E // P)
    jj = ((ii + 1 + rng.randint(0, P - 1, E)) % P).astype(np.int32)
    idx = np.broadcast_to(np.arange(HW, dtype=np.int32), (E, HW)).copy()
    return (T, Xs, np.full((P, HW, 1), 3.0, np.float32), K, ii, jj, idx,
            np.ones((E, HW), bool), np.full((E, HW, 1), 3.0, np.float32), np.ones(E, bool),
            np.ones(P, bool)), h, w


def sharded_gn_line(dev, mesh, fg, what: str = "phase 8's graph") -> str:
    """Phase 13c: the edge-sharded GN over ``mesh`` against the unsharded
    solve, on the JAX dry run's 64-edge problem and on a System's factor
    graph ``fg`` (``what``) at its final (P, E) (its poses solved again
    from the same start by each): the largest |dT| and the ms of each."""
    import torch
    from artdeco_tpu_torch.vslam import global_opt as go

    arrays, h, w = dryrun_gn_problem()
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    out = {}
    for name, solve in (("single", go.gauss_newton_calib),
                        ("sharded", lambda *a, **k: go.gauss_newton_calib_sharded(
                            mesh, "dp", *a, **k))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = solve(*args, h, w, max_iter=10, num_fix=1).cpu().numpy()
        out[name + "_ms"] = 1e3 * (time.perf_counter() - t0)
    dT = float(np.abs(out["single"] - out["sharded"]).max())
    ident = np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (16, 1))
    conv = float(np.abs(out["single"] - ident).max())
    check(dT < 1e-4 and conv < 1e-3, f"13c dry-run problem: |dT| {dT}, from the optimum {conv}")

    kfs = fg.keyframes
    n_kf = len(kfs)
    T0 = kfs.T_WC[:n_kf].copy()
    mesh0, sharded0 = fg.mesh, fg.sharded_solves
    res = {}
    for name, m in (("single", None), ("sharded", mesh)):
        fg.enable_mesh(m)
        kfs.T_WC[:n_kf] = T0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fg.solve_GN_calib()
        torch.cuda.synchronize()
        res[name + "_ms"] = 1e3 * (time.perf_counter() - t0)
        res[name] = kfs.T_WC[:n_kf].copy()
    check(fg.sharded_solves == sharded0 + 1, f"13c: {what} took the unsharded solver")
    fg.enable_mesh(mesh0)
    P, E, n_e = fg.solves[-1]
    dT8 = float(np.abs(res["single"] - res["sharded"]).max())
    check(dT8 < 1e-4, f"13c {what}: |dT| {dT8}")
    return (f"the dry run's problem (16 poses, 64 edges over {mesh.size} slots, 32x24): max "
            f"|dT| {dT:.3g} against the unsharded solve, {conv:.3g} from the optimum; "
            f"{out['sharded_ms']:.1f} ms sharded vs {out['single_ms']:.1f} ms (host clock, "
            f"first calls); {what} at (P, E, edges) ({P}, {E}, {n_e}), {n_kf} "
            f"keyframes: max |dT| {dT8:.3g}, solve_GN_calib {res['sharded_ms']:.1f} ms sharded "
            f"vs {res['single_ms']:.1f} ms")


def mesh_system_line(dev, cfg, mesh, ref) -> tuple:
    """Phase 13d: ``System.run`` (overlapped) over the first ``MESH_FRAMES``
    frames of phase 8's stream with ``System.enable_mesh(mesh)``: 0 lost,
    training only through dp steps, K1/K2/K3 launches as the calls that
    launch them, every GN solve sharded, ATE < 0.03 m, a finite test PSNR.
    Returns (the line, the launches)."""
    import tempfile

    import torch
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset

    args = system_args(max_size_slam=SYS_W)
    ds = SyntheticDataset(args, n_frames=MESH_FRAMES, width=SYS_W, height=SYS_H)
    sys_, reg_s = make_system(dev, ds, cfg, args)
    sys_.enable_mesh(mesh)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    sys_.run(progress=False)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    meta = sys_.save(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    torch.cuda.synchronize()
    launches = read_launches()
    sm, fg = sys_.scene_model, sys_.backend.factor_graph
    n_kf = len(sys_.keyframes)
    kf_frames = sys_.keyframes.dataset_idx[:n_kf].tolist()
    check(sys_.frontend.lost_number == 0, f"13d: {sys_.frontend.lost_number} frames lost")
    check(sm._dp_steps and sm.n_dp_steps > 0 and sm.n_train_steps == 0,
          f"13d: {sm.n_dp_steps} dp steps, {sm.n_train_steps} single steps")
    check(launches["bwd"] == mesh.size * sm.n_dp_steps,
          f"13d: K2 launches {launches['bwd']} != {mesh.size} x {sm.n_dp_steps} dp steps")
    line = check_system_launches(sys_, launches, "13d")
    check(len(fg.solves) >= 1 and fg.sharded_solves == len(fg.solves),
          f"13d: {fg.sharded_solves} of {len(fg.solves)} GN solves sharded")
    want_kf = [k for k in ref["kf_frames"] if k < MESH_FRAMES]
    ate = meta["trajectory"]["APE"]["rmse"]
    psnr = meta["metrics"].get("PSNR", float("nan"))
    check(ate < 0.03, f"13d: ATE RMSE {ate} m")
    check(np.isfinite(psnr), f"13d: test PSNR {psnr}")
    out = (f"{MESH_FRAMES} frames of phase 8's stream at {SYS_W}x{SYS_H}, overlapped, "
           f"{mesh.size} slots sharing one card (oracle registered in {reg_s:.1f} s): lost 0; "
           f"keyframes {n_kf} at frames "
            f"{kf_frames} (phase 8: {want_kf}); dp steps {sm.n_dp_steps}, sharded renders "
            f"{sm.n_sharded_renders}; {line}; GN solves {len(fg.solves)}, all sharded; ATE "
            f"RMSE {ate:.5f} m (phase 8: {ref['ate']:.5f} over {SYS_FRAMES}); test PSNR "
            f"{psnr:.2f} dB (phase 8: {ref['psnr']:.2f}); Gaussians {meta['n_gaussians']} "
            f"(phase 8: {ref['n_gaussians']}); {frame_ms_line(sys_, MESH_FRAMES, run_s)} "
            f"(phase 8: {ref['ms']:.2f} ms, {ref['fps']:.2f} FPS)")
    del sys_, sm, fg
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def k1_from_another_card(devices) -> str:
    """Phase 13e: K1 on ``devices[0]``'s data, launched from a thread whose
    current device is ``devices[1]``, against its plain version."""
    import threading

    import torch
    from artdeco_tpu_torch.ops.splat import composite as C

    p = random_slots(devices[0])
    args = (p.slot_data.contiguous(), p.pad_starts, p.pad_counts, p.tiles_x, p.tiles_y)
    got = {}

    def run():
        torch.cuda.set_device(devices[1])
        got["out"], got["stop"] = C.composite_fwd(*args)
        torch.cuda.synchronize(devices[0])

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    check(not th.is_alive() and "out" in got, "13e: the K1 thread did not finish")
    ref, stop = C.composite_fwd_plain(*args)
    err = float((got["out"] - ref).abs().max())
    check(err <= 1e-3 and torch.equal(got["stop"], stop),
          f"13e: K1 from {devices[1]}'s thread: err {err}")
    return f"K1 on {devices[0]}'s data from a thread on {devices[1]}: max err {err:.3g}"


def distinct_cards_phase(dev, cfg, k: int) -> None:
    """Phase 13e, on a machine with ``k`` (2 or 4) cards or more:
    ``run_system --oracle --n_devices k`` over the first ``MESH_FRAMES``
    frames of phase 8's stream, then (a)-(c) over the ``k`` cards on that
    run's scene and factor graph (and the random scene), and K1 launched
    from a thread whose current device is another card."""
    import tempfile

    import torch
    from artdeco_tpu_torch.dataio import dataset as D
    from artdeco_tpu_torch.parallel.mesh import Mesh

    cards = Mesh([torch.device("cuda", i) for i in range(k)])
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    argv = ["-s", "synthetic://", "-d", "synthetic", "--oracle", "--test_hold",
            str(TEST_HOLD), "--max_size_slam", str(SYS_W), "--retrieval_checkpoint_path", "",
            "--n_devices", str(k), "-m", out_dir]
    load = D.load_dataset
    D.load_dataset = lambda a: D.SyntheticDataset(a, n_frames=MESH_FRAMES, width=SYS_W,
                                                  height=SYS_H)
    try:
        meta, sys_, run_s, launches = run_entry(argv)
    finally:
        D.load_dataset = load
    sm, fg = sys_.scene_model, sys_.backend.factor_graph
    check(sm._mesh.devices == cards.devices, f"13e: run_system's mesh {sm._mesh}")
    line = check_system_launches(sys_, launches, "13e")
    ate = meta["trajectory"]["APE"]["rmse"]
    check(sys_.frontend.lost_number == 0 and ate < 0.03, f"13e: run_system lost "
          f"{sys_.frontend.lost_number} frames, ATE {ate} m")
    check(fg.sharded_solves == len(fg.solves) >= 1, "13e: unsharded GN solves")
    print(f"phase 13e run_system --oracle --n_devices {k} ({k} cards): {MESH_FRAMES} frames, "
          f"{frame_ms_line(sys_, MESH_FRAMES, run_s)}; dp steps {sm.n_dp_steps}; {line}; ATE "
          f"{ate:.5f} m; PSNR {meta['metrics'].get('PSNR', float('nan')):.2f} dB", flush=True)
    view = len(sm.keyframes) - 1
    big = random_scene(dev, N_BIG)
    print(f"phase 13e {k} cards: {strip_render_line(sm, cards, view, 'the run scene')}; "
          f"{strip_render_line(big, cards, 0, f'random scene of {N_BIG} Gaussians')}; "
          f"dp step {dp_step_line(sm, cards, dev)}; GN "
          f"{sharded_gn_line(dev, cards, fg, 'the run graph')}; "
          f"{k1_from_another_card(cards.devices)}", flush=True)


def mesh_phase(dev, cfg, ref) -> dict:
    """Phase 13: the multi-device path (see the module docstring).  Returns
    13d's launches."""
    import torch
    from artdeco_tpu_torch.parallel.mesh import Mesh

    t0 = time.time()
    virtual = Mesh([dev] * MESH_SLOTS)
    sm8, fg8 = ref["scene_model"], ref["factor_graph"]
    view = len(sm8.keyframes) - 1
    big = random_scene(dev, N_BIG)
    print(f"phase 13a strip renders, {MESH_SLOTS} slots sharing one card: "
          f"{strip_render_line(sm8, virtual, view, f'phase 8 scene, keyframe {view}')}; "
          f"{strip_render_line(big, virtual, 0, f'random scene of {N_BIG} Gaussians')}",
          flush=True)
    print(f"phase 13b dp step, {MESH_SLOTS} slots sharing one card: "
          f"{dp_step_line(sm8, virtual, dev)}", flush=True)
    print(f"phase 13c sharded GN, {MESH_SLOTS} slots sharing one card: "
          f"{sharded_gn_line(dev, virtual, fg8)}", flush=True)
    line, launches = mesh_system_line(dev, cfg, virtual, ref)
    print(f"phase 13d System with the mesh: {line}", flush=True)
    count = torch.cuda.device_count()
    if count >= 2:
        distinct_cards_phase(dev, cfg, 4 if count >= 4 else 2)
    else:
        print(f"phase 13e: this machine has {count} card; the distinct-card runs did not run",
              flush=True)
    print(f"phase 13 took {time.time() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the viewers
# ---------------------------------------------------------------------------

class WsClient:
    """A minimal WebSocket client on the standard library, apart from the
    port's server: the Upgrade handshake (the accept key checked), masked
    text frames out, whole frames in."""

    def __init__(self, port: int, timeout: float = 60.0):
        import base64
        import hashlib
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            self._fill()
        head, self.buf = self.buf.split(b"\r\n\r\n", 1)
        accept = base64.b64encode(hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
        check(head.startswith(b"HTTP/1.1 101") and b"Sec-WebSocket-Accept: " + accept in head,
              f"WebSocket handshake answered {head[:120]!r}")

    def _fill(self) -> None:
        chunk = self.sock.recv(1 << 20)
        if not chunk:
            raise ConnectionError("the server closed the socket")
        self.buf += chunk

    def _take(self, n: int) -> bytes:
        while len(self.buf) < n:
            self._fill()
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def recv(self):
        b0, b1 = self._take(2)
        check(b0 & 0x80 and not b1 & 0x80, f"server frame header {b0:#x} {b1:#x}")
        n = b1 & 0x7F
        if n >= 126:
            n = int.from_bytes(self._take(2 if n == 126 else 8), "big")
        data, op = self._take(n), b0 & 0x0F
        if op == 0x8:
            raise ConnectionError(f"closed by the server, code {int.from_bytes(data[:2], 'big')}")
        return data.decode() if op == 0x1 else data

    def _send(self, op: int, payload: bytes) -> None:
        n, mask = len(payload), os.urandom(4)
        size = (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + n.to_bytes(2, "big")
                if n < 1 << 16 else bytes([0x80 | 127]) + n.to_bytes(8, "big"))
        body = (np.frombuffer(payload, np.uint8) ^ np.resize(np.frombuffer(mask, np.uint8), n))
        self.sock.sendall(bytes([0x80 | op]) + size + mask + body.tobytes())

    def send_text(self, text: str) -> None:
        self._send(0x1, text.encode())

    def close(self) -> None:
        try:
            self._send(0x8, (1000).to_bytes(2, "big"))
            while True:
                self.recv()
        except (ConnectionError, OSError):
            pass
        self.sock.close()


def free_port_pair() -> int:
    """A port p on 127.0.0.1 with p + 1 free too: the viewer's WebSocket
    and its page."""
    import socket

    for _ in range(100):
        with socket.socket() as a, socket.socket() as b:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            try:
                b.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
            return p
    raise RuntimeError("no two free neighbouring ports on 127.0.0.1")


def web_request(Rt_w2c: np.ndarray, mode: str, snap: bool = False) -> str:
    """The page's request for the view ``Rt_w2c``: its column-major c2w
    with Y and Z flipped (the server flips them back and inverts)."""
    pose = np.linalg.inv(np.asarray(Rt_w2c, np.float64))
    pose[:3, 1] *= -1
    pose[:3, 2] *= -1
    return json.dumps(dict(res_x=WEB_RES[0], res_y=WEB_RES[1], pose=pose.T.flatten().tolist(),
                           snapToLast=snap, mode=mode, state="play"))


def stage_ms(timers: dict, n: int) -> str:
    return ", ".join(f"{k} {1e3 * v[0] / max(n, 1):.2f}" for k, v in timers.items())


def loaded_scene_line(sm, run_dir: str, Rt, dev, what: str) -> tuple:
    """Phase 14a on one scene: ``load_scene_for_viewing`` of its saved
    directory, rendered at ``Rt`` against the live scene with ``d_max``
    lifted.  Returns (the line, the loaded scene)."""
    import torch
    from artdeco_tpu_torch.mapper.scene_io import load_scene_for_viewing
    from artdeco_tpu_torch.runtime.gaussianviewer import render_view

    vs = load_scene_for_viewing(run_dir, device=dev)
    check((vs.width, vs.height, vs.f) == (sm.width, sm.height, sm.f),
          f"phase 14a {what}: loaded camera {vs.width}x{vs.height} f {vs.f}")
    check(int(vs.slab.active.sum()) == sm.n_active_gaussians,
          f"phase 14a {what}: {int(vs.slab.active.sum())} Gaussians loaded of "
          f"{sm.n_active_gaussians}")
    live_slab = dataclasses.replace(sm.slab, d_max=torch.full_like(sm.slab.d_max, 1e10))
    loaded = render_view(vs, Rt, sm.width, sm.height)["render"]
    live = render_view(sm, Rt, sm.width, sm.height, slab=live_slab)["render"]
    diff = (loaded - live).abs().amax(0)
    err, share = float(diff.max()), float((diff > LOADED_TOL).float().mean())
    check(share <= LOADED_CUT_SHARE and float(live.max()) > 0.1,
          f"phase 14a {what}: loaded render off the live one by up to {err:.3g} on "
          f"{share:.3g} of the pixels (> {LOADED_TOL})")
    return (f"{what}: {sm.n_active_gaussians} Gaussians loaded, RGB within {err:.3g} of the "
            f"live render with d_max lifted ({share:.3g} of the pixels over {LOADED_TOL})"), vs


def turntable_line(vs, out_dir: str, what: str) -> tuple:
    """Phase 14b on one loaded scene: ``export_turntable`` in each mode;
    every PNG decodes to its rendered frame bit for bit, the MP4 holds a
    JPEG of VIEW_W x VIEW_H for every frame, K1 launches equal the
    renders.  Returns (the line, K1 launches)."""
    from artdeco_tpu_torch.dataio.image_io import read_png
    from artdeco_tpu_torch.dataio.jpeg import jpeg_size
    from artdeco_tpu_torch.dataio.video import read_mp4_samples
    from artdeco_tpu_torch.ops.splat import composite as C
    from artdeco_tpu_torch.runtime.gaussianviewer import GaussianViewer

    parts, fwd = [], 0
    for mode in ("splat", "depth", "alpha"):
        viewer = GaussianViewer(vs, VIEW_W, VIEW_H)
        viewer.sync_timing = True
        frames, turntable = [], viewer.turntable
        # keep the frames the export renders, to hold its files to them
        viewer.turntable = lambda *a: frames.extend(turntable(*a)) or frames
        C.composite_fwd.launches = 0
        d = os.path.join(out_dir, mode)
        vid = viewer.export_turntable(d, VIEW_FRAMES, mode)
        check(C.composite_fwd.launches == viewer.renders == VIEW_FRAMES,
              f"phase 14b {what} {mode}: K1 launches {C.composite_fwd.launches} for "
              f"{viewer.renders} renders")
        fwd += C.composite_fwd.launches
        bad = [i for i, fr in enumerate(frames)
               if not np.array_equal(read_png(os.path.join(d, f"{mode}_{i:04d}.png")), fr)]
        check(not bad, f"phase 14b {what} {mode}: PNG frames {bad[:5]} differ from the renders")
        mp4 = read_mp4_samples(vid)
        sizes = {jpeg_size(s) for s in mp4["samples"]}
        check(len(mp4["samples"]) == VIEW_FRAMES and sizes == {(VIEW_W, VIEW_H)}
              and mp4["kind"] == "jpeg" and mp4["fps"] == 30.0,
              f"phase 14b {what} {mode}: MP4 of {len(mp4['samples'])} samples, sizes {sizes}")
        check(max(int(fr.max()) for fr in frames) > 0, f"phase 14b {what} {mode}: black frames")
        parts.append(f"{mode} ({stage_ms(viewer.timers, VIEW_FRAMES)})")
    return (f"{what}: {VIEW_FRAMES} frames {VIEW_W}x{VIEW_H} a mode, PNGs bit for bit, MP4 "
            f"of {VIEW_FRAMES} JPEG samples, K1 = renders; ms a frame (render "
            f"device-synchronised): " + "; ".join(parts)), fwd


def web_replies_line(sm, Rt, what: str) -> tuple:
    """Phase 14c on one scene: the WebViewer on 127.0.0.1 and its page on
    the next port; the splat, depth and ellipsoid modes and snapToLast at
    WEB_RES, each reply a JPEG of half that.  Returns (the line, K1
    launches)."""
    import http.client

    from artdeco_tpu_torch.dataio.jpeg import jpeg_size
    from artdeco_tpu_torch.ops.splat import composite as C
    from artdeco_tpu_torch.runtime.webviewer import STATIC_DIR, WebViewer, serve_static_page

    viewer = WebViewer(sm, ip="127.0.0.1", port=free_port_pair())
    C.composite_fwd.launches = 0
    viewer.start_background()
    httpd = serve_static_page("127.0.0.1", viewer.port + 1)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", viewer.port + 1, timeout=30)
        conn.request("GET", "/")
        page = conn.getresponse().read()
        conn.close()
        with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
            check(page == f.read(), f"phase 14c {what}: GET / is not the viewer page")
        client = WsClient(viewer.port)
        asks = [("splat", False), ("depth", False), ("ellipsoid", False), ("splat", True)]
        for warm in range(2):                      # the first round warms up
            viewer.timers.clear()
            viewer.sync_timing = bool(warm)
            ms = []
            for mode, snap in asks * (1 + 2 * warm):
                header = json.loads(client.recv())
                t0 = time.perf_counter()
                client.send_text(web_request(Rt, mode, snap))
                reply = client.recv()
                ms.append(1e3 * (time.perf_counter() - t0))
                check(isinstance(reply, bytes)
                      and jpeg_size(reply) == (WEB_RES[0] // 2, WEB_RES[1] // 2),
                      f"phase 14c {what} {mode}: reply {reply[:16]!r}")
        client.close()
        n = len(ms)
    finally:
        viewer.shutdown()
        httpd.shutdown()
        httpd.server_close()
    check(viewer.failures == 0 and C.composite_fwd.launches == viewer.renders == 4 + 3 * 4,
          f"phase 14c {what}: failures {viewer.failures}, K1 {C.composite_fwd.launches}, "
          f"renders {viewer.renders}")
    med = statistics.median(ms)
    return (f"{what}: header keys {sorted(header)}; {n} replies of "
            f"{WEB_RES[0] // 2}x{WEB_RES[1] // 2} JPEG (splat, depth, ellipsoid, snapToLast), "
            f"0 failures, K1 = renders {viewer.renders}; reply {med:.2f} ms (median, client "
            f"round trip), {1e3 / med:.1f} replies/s; ms a reply (render device-synchronised): "
            f"{stage_ms(viewer.timers, n)}"), C.composite_fwd.launches


def poll_viewer(port: int, stop, seen: list, errors: list) -> None:
    """Phase 14d's client: connects once the viewer is up and asks for a
    splat render at WEB_RES after every header, as the page does, until
    ``stop``; ``seen`` gets each reply's (seconds, JPEG size)."""
    from artdeco_tpu_torch.dataio.jpeg import jpeg_size

    eye = np.eye(4)
    while not stop.is_set():
        try:
            client = WsClient(port, timeout=10)
        except OSError:
            time.sleep(0.05)
            continue
        try:
            while not stop.is_set():
                client.recv()
                t0 = time.perf_counter()
                client.send_text(web_request(eye, "splat", snap=True))
                reply = client.recv()
                seen.append((time.perf_counter() - t0, jpeg_size(reply)))
        except (ConnectionError, OSError) as e:
            errors.append(repr(e))
        finally:
            client.close()


def viewers_phase(dev, ref, disk_ref) -> dict:
    """Phase 14: the viewers (see the module docstring).  ``ref`` is phase
    8's run, ``disk_ref`` phase 11b's.  Returns K1 launches of (a)-(d) and
    14d's K2 and K3."""
    import tempfile
    import threading

    import torch
    from artdeco_tpu_torch.mapper import keyframe as KF
    from artdeco_tpu_torch.mapper.scene_io import save_gaussian_ply
    from artdeco_tpu_torch.ops.splat import composite as C

    t_phase = time.time()
    launches = {}
    sm8 = ref["scene_model"]
    big = random_scene(dev, N_BIG)
    big_dir = tempfile.mkdtemp(prefix="chip_smoke_big_")
    os.makedirs(os.path.join(big_dir, "point_clouds"))
    save_gaussian_ply(os.path.join(big_dir, "point_clouds", "gs.ply"), big)
    with open(os.path.join(big_dir, "metadata.json"), "w") as f:
        json.dump({"config": {"width": big.width, "height": big.height, "f": big.f}}, f)
    scenes = [("phase 8 scene", sm8, ref["out_dir"], KF.get_Rt(sm8.pool, 0)),
              (f"random scene of {N_BIG} Gaussians", big, big_dir, torch.eye(4, device=dev))]

    # (a) round trip
    C.composite_fwd.launches = 0
    lines, loaded = [], []
    for what, sm, run_dir, Rt in scenes:
        line, vs = loaded_scene_line(sm, run_dir, Rt, dev, what)
        lines.append(line)
        loaded.append(vs)
    launches["phase 14a"] = {"fwd": C.composite_fwd.launches}
    print(f"phase 14a saved scenes loaded: {'; '.join(lines)}", flush=True)

    # (b) turntables
    out = tempfile.mkdtemp(prefix="chip_smoke_turntable_")
    lines, fwd = [], 0
    for i, ((what, *_), vs) in enumerate(zip(scenes, loaded)):
        line, n = turntable_line(vs, os.path.join(out, str(i)), what)
        lines.append(line)
        fwd += n
    launches["phase 14b"] = {"fwd": fwd}
    print(f"phase 14b turntables: {'; '.join(lines)}", flush=True)
    del loaded

    # (c) web replies
    lines, fwd = [], 0
    for what, sm, _, Rt in scenes:
        line, n = web_replies_line(sm, Rt.cpu().numpy(), what)
        lines.append(line)
        fwd += n
    launches["phase 14c"] = {"fwd": fwd}
    print(f"phase 14c web replies: {'; '.join(lines)}", flush=True)
    del big, scenes
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the viewer while the system runs: 11b's run with --viewer_mode web
    port = free_port_pair()
    argv = disk_ref["argv"] + ["-m", tempfile.mkdtemp(prefix="chip_smoke_web_"),
                               "--viewer_mode", "web", "--ip", "127.0.0.1", "--port", str(port)]
    stop, seen, errors = threading.Event(), [], []
    client = threading.Thread(target=poll_viewer, args=(port, stop, seen, errors), daemon=True)
    client.start()
    try:
        meta, sys_, run_s, launches["phase 14d"] = run_entry(argv)
    finally:
        stop.set()
        client.join(timeout=60)
    check(not client.is_alive(), "phase 14d: the polling client did not stop")
    viewer = sys_.viewer
    line = check_system_launches(sys_, launches["phase 14d"], "phase 14d")
    n_kf = len(sys_.keyframes)
    kf = sys_.keyframes.dataset_idx[:n_kf].tolist()
    est = sys_.frontend.estimated_trajectory()
    psnr = meta["metrics"].get("PSNR", float("nan"))
    check(kf == disk_ref["kf"] and sys_.frontend.lost_number == disk_ref["lost"],
          f"phase 14d: keyframes {kf}, lost {sys_.frontend.lost_number} against 11b's "
          f"{disk_ref['kf']}, {disk_ref['lost']}")
    check(est.shape == disk_ref["est"].shape and np.array_equal(est, disk_ref["est"]),
          "phase 14d: poses differ from 11b's")
    check(psnr == disk_ref["psnr"], f"phase 14d: test PSNR {psnr!r} != 11b's {disk_ref['psnr']!r}")
    check(viewer.failures == 0, f"phase 14d: {viewer.failures} failed replies")
    check(len(seen) >= run_s / 2, f"phase 14d: {len(seen)} replies in {run_s:.1f} s")
    check({size for _, size in seen} == {(WEB_RES[0] // 2, WEB_RES[1] // 2)},
          f"phase 14d: reply sizes {({size for _, size in seen})}")
    reply_ms = statistics.median([1e3 * t for t, _ in seen])
    print(f"phase 14d viewer during run_system.main {' '.join(argv[:-8])} --viewer_mode web: "
          f"keyframes {kf}, lost {sys_.frontend.lost_number}, every pose and the test PSNR "
          f"{psnr!r} dB bitwise 11b's; {line}; {len(seen)} replies in {run_s:.1f} s "
          f"({len(seen) / run_s:.2f}/s), reply {reply_ms:.2f} ms (median), failures "
          f"{viewer.failures}; {frame_ms_line(sys_, DISK_ENTRY_FRAMES, run_s)} against 11b's "
          f"{disk_ref['ms']:.2f} ms, {disk_ref['fps']:.2f} FPS; client errors after the "
          f"server stopped {len(errors)}", flush=True)
    del sys_, viewer
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14 took {time.time() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the tools
# ---------------------------------------------------------------------------

class StreamView:
    """Frames ``idx`` of ``ds``, each passed through ``warp`` when one is
    given: what ``write_stream`` reads of a dataset."""

    def __init__(self, ds, idx, warp=None):
        self.ds, self.idx, self.warp = ds, list(idx), warp
        self.W, self.H = ds.W, ds.H
        self.timestamp = [ds.timestamp[i] for i in self.idx]
        self.Twc_gt = np.asarray(ds.Twc_gt)[self.idx]
        self.image_name_list = [ds.image_name_list[i] for i in self.idx]

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        img, info = self.ds[self.idx[i]]
        return (img if self.warp is None else self.warp(img)), info


def distortion_maps(params, w: int, h: int) -> tuple:
    """Where each pixel of a camera with ``params``'s lens (K_in and its
    distortion) samples the ideal camera that ``rectify_tum`` rectifies to
    (K_out, alpha 1): its undistorted position, by OpenCV's fixed-point
    iteration run to convergence over the whole grid at once."""
    from artdeco_tpu_torch.scripts.rectify_tum import rectified_K

    K_in, dist, K_out = rectified_K(params, h, w)
    k = np.zeros(5)
    k[:len(dist)] = dist                     # k1 k2 p1 p2 k3
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x0 = x = (u - K_in[0, 2]) / K_in[0, 0]
    y0 = y = (v - K_in[1, 2]) / K_in[1, 1]
    for _ in range(40):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return ((K_out[0, 0] * x + K_out[0, 2]).astype(np.float32),
            (K_out[1, 1] * y + K_out[1, 2]).astype(np.float32))


def bilinear_warp(mapx: np.ndarray, mapy: np.ndarray):
    """A function that samples an (H, W, 3) uint8 image at the maps'
    positions, bilinearly, 0 outside: taps and float32 weights computed
    once, four gathers a frame."""
    h, w = mapx.shape
    x0, y0 = np.floor(mapx), np.floor(mapy)
    ax, ay = (mapx - x0).astype(np.float32), (mapy - y0).astype(np.float32)
    taps = []
    for dy, dx, wt in ((0, 0, (1 - ax) * (1 - ay)), (0, 1, ax * (1 - ay)),
                       (1, 0, (1 - ax) * ay), (1, 1, ax * ay)):
        yy, xx = y0.astype(np.int64) + dy, x0.astype(np.int64) + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        taps.append(((np.clip(yy, 0, h - 1) * w + np.clip(xx, 0, w - 1)).ravel(),
                     np.where(inside, wt, 0).astype(np.float32).ravel()[:, None]))

    def warp(img):
        flat = img.reshape(-1, img.shape[2]).astype(np.float32)
        acc = sum(flat[i] * wt for i, wt in taps)
        return np.clip(np.rint(acc), 0, 255).astype(np.uint8).reshape(img.shape)

    return warp


def quiet(fn, *args):
    """``fn(*args)`` with its stdout kept: (its result, the text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def rectify_line(root: str) -> tuple:
    """15a: a TUM sequence seen through fr1_desk's lens, rectified by
    ``rectify_tum``; its frames against the clean ones.  Returns (the line,
    the clean frames' view, the rectified images' folder)."""
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
    from artdeco_tpu_torch.dataio.image_io import read_png
    from artdeco_tpu_torch.scripts import rectify_tum

    scene = "TUM/rgbd_dataset_freiburg1_desk"
    params = rectify_tum.TUM_CALIB[scene]
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=TOOLS_W),
                          n_frames=TOOLS_FRAMES, width=TOOLS_W, height=TOOLS_H)
    seq = StreamView(ds, range(TOOLS_FRAMES), bilinear_warp(*distortion_maps(
        params, TOOLS_W, TOOLS_H)))
    scene_dir = os.path.join(root, scene)
    t0 = time.time()
    write_stream(seq, scene_dir, tum=True)
    write_s = time.time() - t0
    t0 = time.perf_counter()
    _, said = quiet(rectify_tum.main, ["--base_dir", root, "--scenes", scene])
    rect_s = time.perf_counter() - t0
    check(f"{TOOLS_FRAMES} images rectified (f=500.1)" in said,
          f"phase 15a: rectify_tum said {said!r}")
    with open(os.path.join(scene_dir, "calib.yaml")) as f:
        calib = f.read()
    check(calib.startswith("fx: 500.087452\nfy: 500.087452\ncx: 319.500000\ncy: 239.500000\n"),
          f"phase 15a: calib.yaml {calib!r}")
    names = sorted(os.listdir(os.path.join(scene_dir, "images")))
    check(len(names) == TOOLS_FRAMES, f"phase 15a: {len(names)} rectified frames")
    mask = read_png(os.path.join(scene_dir, "masks", names[0]))[..., 0]
    valid = mask == 255
    zeros = int(np.sum(mask == 0))
    check(np.all(valid | (mask == 0)), "phase 15a: the mask holds values other than 0 and 255")
    err_max, err_sum = 0, 0.0
    for i, name in enumerate(names):
        got = read_png(os.path.join(scene_dir, "images", name)).astype(np.int64)
        check(np.array_equal(read_png(os.path.join(scene_dir, "masks", name))[..., 0], mask),
              f"phase 15a: frame {i}'s mask differs from frame 0's")
        check(not got[~valid].any(), f"phase 15a: frame {i} is not black outside the mask")
        d = np.abs(got - ds[i][0])[valid]
        err_max, err_sum = max(err_max, int(d.max())), err_sum + float(d.mean())
    err_mean = err_sum / len(names)
    check(err_max <= RECT_MAX_LEVELS and err_mean <= RECT_MEAN_LEVELS,
          f"phase 15a: rectified frames off the clean ones by up to {err_max} levels, "
          f"{err_mean:.4f} mean (bounds {RECT_MAX_LEVELS}, {RECT_MEAN_LEVELS})")
    check(zeros == RECT_MASK_ZEROS, f"phase 15a: {zeros} mask zeros, the CPU run's "
          f"{RECT_MASK_ZEROS}")
    # one frame's rectification on the host, step by step, and the data
    # path's undistortion (alpha 0) in to_slam and to_map at this size
    from artdeco_tpu_torch.dataio.camera import PinholeCamera, undistort_maps
    from artdeco_tpu_torch.dataio.image_io import load_image
    from artdeco_tpu_torch.dataio.resample import remap_bilinear
    from artdeco_tpu_torch.mapper.scene_io import write_png

    src = os.path.join(scene_dir, "rgb", sorted(os.listdir(os.path.join(scene_dir, "rgb")))[0])
    K_in, dist, K_out = rectify_tum.rectified_K(params, TOOLS_H, TOOLS_W)
    t = [time.perf_counter()]
    img = load_image(src)
    t.append(time.perf_counter())
    ux, uy = undistort_maps(K_in, dist, K_out, TOOLS_W, TOOLS_H)
    rect = remap_bilinear(img, ux, uy, border="reflect")
    t.append(time.perf_counter())
    tmp = os.path.join(root, "one.png")
    write_png(tmp, np.concatenate([rect, mask[..., None]], -1))
    write_png(tmp, mask)
    t.append(time.perf_counter())
    cam = PinholeCamera(512, 2, TOOLS_W, TOOLS_H, params)
    frames = [load_image(os.path.join(scene_dir, "rgb", n)) for n in
              sorted(os.listdir(os.path.join(scene_dir, "rgb")))[:8]]
    t1 = time.perf_counter()
    for fr in frames:
        cam.to_slam(fr)
    t2 = time.perf_counter()
    for fr in frames:
        cam.to_map(fr)
    t3 = time.perf_counter()
    line = (f"{TOOLS_FRAMES} frames {TOOLS_W}x{TOOLS_H} through fr1_desk's lens written in "
            f"{write_s:.1f} s; rectify_tum {rect_s:.2f} s ({1e3 * rect_s / TOOLS_FRAMES:.2f} "
            f"host ms a frame, its thread pool), calib.yaml f 500.087452; rectified against the "
            f"clean frames inside the mask: max {err_max} levels, mean {err_mean:.4f} (bounds "
            f"{RECT_MAX_LEVELS}, {RECT_MEAN_LEVELS}); mask zeros {zeros} (CPU run "
            f"{RECT_MASK_ZEROS}); one frame on the host: decode {1e3 * (t[1] - t[0]):.2f} ms, "
            f"maps + reflected remap {1e3 * (t[2] - t[1]):.2f} ms, RGBA and mask PNGs "
            f"{1e3 * (t[3] - t[2]):.2f} ms; the data path's undistortion (alpha 0) at "
            f"{TOOLS_W}x{TOOLS_H}, host ms per frame over 8: to_slam "
            f"{1e3 * (t2 - t1) / 8:.2f}, to_map {1e3 * (t3 - t2) / 8:.2f}")
    return line, os.path.join(scene_dir, "images")


def small_tools_line(root: str, images: str) -> str:
    """15b: downsampleImage at factors 2 and 1.5 on 641x481 PNGs, img_summary
    over the folders, img2vid on the 641x481 frames."""
    from artdeco_tpu_torch.dataio.image_io import image_size, read_png
    from artdeco_tpu_torch.dataio.jpeg import jpeg_size
    from artdeco_tpu_torch.dataio.video import read_mp4_samples
    from artdeco_tpu_torch.mapper.scene_io import write_png
    from artdeco_tpu_torch.scripts import downsampleImage, img2vid, img_summary

    odd = os.path.join(root, "odd")
    os.makedirs(odd)
    names = sorted(os.listdir(images))[:DOWN_FRAMES]
    for n in names:
        write_png(os.path.join(odd, n), np.pad(read_png(os.path.join(images, n)),
                                               ((0, 1), (0, 1), (0, 0)), mode="edge"))
    t = [time.perf_counter()]
    sizes = {}
    for factor, want in (("2", (320, 240)), ("1.5", (427, 321))):
        out = os.path.join(root, f"x{factor}")
        _, said = quiet(downsampleImage.main, [odd, "-o", out, "--factor", factor])
        t.append(time.perf_counter())
        got = {image_size(os.path.join(out, n)) for n in names}
        check(said == "done\n" and got == {want},
              f"phase 15b: downsampleImage --factor {factor}: sizes {got}, said {said!r}")
        sizes[factor] = got
    # factor 2 is OpenCV's 2x2 fast path: (sum + 2) >> 2 of the whole blocks
    a = read_png(os.path.join(odd, names[0]))[:480, :640].astype(np.int64)
    block = (a.reshape(240, 2, 320, 2, 3).sum(axis=(1, 3)) + 2) >> 2
    check(np.array_equal(read_png(os.path.join(root, "x2", names[0])), block),
          "phase 15b: downsampleImage --factor 2 is not the 2x2 block average")
    dirs = [images, os.path.dirname(images) + "/masks", odd] + [os.path.join(root, f"x{f}")
                                                               for f in ("2", "1.5")]
    _, csv = quiet(img_summary.main, dirs)
    want = (f"name,count,image_size\nimages,{TOOLS_FRAMES},{TOOLS_W}x{TOOLS_H}\n"
            f"masks,{TOOLS_FRAMES},{TOOLS_W}x{TOOLS_H}\n"
            f"odd,{DOWN_FRAMES},{TOOLS_W + 1}x{TOOLS_H + 1}\nx2,{DOWN_FRAMES},320x240\n"
            f"x1.5,{DOWN_FRAMES},427x321\nmin {DOWN_FRAMES} max {TOOLS_FRAMES}\n")
    check(csv == want, f"phase 15b: img_summary printed {csv!r}, not {want!r}")
    t.append(time.perf_counter())
    mp4 = os.path.join(root, "odd.mp4")
    _, said = quiet(img2vid.main, [odd, "-o", mp4])
    t.append(time.perf_counter())
    back = read_mp4_samples(mp4)
    check(said == f"wrote {mp4} ({DOWN_FRAMES} frames)\n" and back["fps"] == 30.0
          and (back["kind"], back["width"], back["height"]) == ("jpeg", TOOLS_W + 1, TOOLS_H + 1)
          and len(back["samples"]) == DOWN_FRAMES
          and {jpeg_size(s) for s in back["samples"]} == {(TOOLS_W + 1, TOOLS_H + 1)},
          f"phase 15b: img2vid's MP4 {dict(back, samples=len(back['samples']))}, said {said!r}")
    return (f"downsampleImage on {DOWN_FRAMES} PNGs of {TOOLS_W + 1}x{TOOLS_H + 1}: --factor 2 "
            f"-> 320x240 (the 2x2 block average) in {t[1] - t[0]:.2f} s, --factor 1.5 -> "
            f"427x321 in {t[2] - t[1]:.2f} s; img_summary over 5 folders, the CSV as "
            f"expected, {1e3 * (t[3] - t[2]):.1f} ms; img2vid {DOWN_FRAMES} frames "
            f"{TOOLS_W + 1}x{TOOLS_H + 1} in {t[4] - t[3]:.2f} s, {len(back['samples'])} JPEG "
            f"samples of {back['width']}x{back['height']} at {back['fps']:.0f} fps read back")


def run_tool(cmd, env=None, timeout=600) -> subprocess.CompletedProcess:
    """A tool as users run it from the repository's root; its output is
    kept and shown if it fails."""
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    check(res.returncode == 0, f"{' '.join(cmd[:4])} exited {res.returncode}:\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res


def run_dir_summary(out: str) -> dict:
    """What a run of the entry point left in ``out``: its metadata, lost
    share and ATE."""
    check(os.path.isfile(os.path.join(out, "run_metadata.json")),
          f"no run_metadata.json in {out}")
    with open(os.path.join(out, "run_metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(out, "slam", "lost_percentage.txt")) as f:
        lost = float(f.read())
    ate = (meta.get("trajectory") or {}).get("APE", {}).get("rmse", float("nan"))
    return dict(meta=meta, lost=lost, ate=ate, ms=1e3 * meta["time"] / max(meta["n_frames"], 1))


def same_files(a: str, b: str, rels) -> list:
    """The files of ``rels`` whose bytes differ between runs ``a`` and ``b``
    (a file one run wrote and the other did not differs; ``frames.txt`` is
    not written when every frame was lost)."""
    out = []
    for rel in rels:
        fa, fb = os.path.join(a, rel), os.path.join(b, rel)
        if not (os.path.isfile(fa) or os.path.isfile(fb)):
            continue
        if not (os.path.isfile(fa) and os.path.isfile(fb)):
            out.append(rel)
            continue
        with open(fa, "rb") as f, open(fb, "rb") as g:
            if f.read() != g.read():
                out.append(rel)
    return out


def matrix_phase(root: str) -> tuple:
    """15c: ``train_eval_all --datasets tum`` over three TUM scenes (three
    consecutive windows of one synthetic stream), each run a subprocess
    of the entry point; the first scene's command again in this process.
    Returns (the line, that run's launches)."""
    import torch
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
    from artdeco_tpu_torch.scripts.train_eval_all import MATRIX

    scenes = MATRIX["tum"]["scenes"]
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=MATRIX_W),
                          n_frames=3 * MATRIX_FRAMES, width=MATRIX_W, height=MATRIX_H)
    data_root, save_root = os.path.join(root, "data"), os.path.join(root, "results")
    t0 = time.time()
    for k, scene in enumerate(scenes):
        calib = write_stream(StreamView(ds, range(k * MATRIX_FRAMES, (k + 1) * MATRIX_FRAMES)),
                             os.path.join(data_root, "tum", scene), tum=True)
    write_s = time.time() - t0
    extra = " ".join(["--oracle", "--calib", calib, "--seq_length", str(MATRIX_FRAMES),
                      *SUBPROCESS_ARGS])
    torch.cuda.empty_cache()
    t0 = time.time()
    res = run_tool([sys.executable, "-m", "artdeco_tpu_torch.scripts.train_eval_all",
                    "--data_root", data_root, "--datasets", "tum", "--save_root", save_root,
                    "--extra", extra])
    matrix_s = time.time() - t0
    cmds = [ln[2:].split() for ln in res.stdout.splitlines() if ln.startswith("+ ")]
    check(len(cmds) == 3 and all(c[1:3] == ["-m", "artdeco_tpu_torch.run_system"]
                                 for c in cmds), f"phase 15c: commands {cmds}")
    runs = []
    for scene in scenes:
        r = run_dir_summary(os.path.join(save_root, "tum", scene))
        check(r["lost"] == 0, f"phase 15c {scene}: lost share {r['lost']}")
        check(r["ate"] < 0.03, f"phase 15c {scene}: ATE RMSE {r['ate']} m")
        check(r["meta"]["n_frames"] == MATRIX_FRAMES,
              f"phase 15c {scene}: {r['meta']['n_frames']} frames")
        runs.append(r)
    # the first command again, in this process, into its own folder
    argv = cmds[0][3:]
    out_sub = argv[argv.index("-m") + 1]
    out_in = os.path.join(root, "inprocess")
    argv[argv.index("-m") + 1] = out_in
    meta, sys_, run_s, launches = run_entry(argv)
    line = check_system_launches(sys_, launches, "phase 15c")
    rels = ["slam/frames.txt", "slam/keyframes.txt", "colmap/images.bin", "point_clouds/gs.ply"]
    diff = same_files(out_sub, out_in, rels)
    check(not diff, f"phase 15c: the in-process run's {diff} differ from the subprocess's")
    del sys_
    gc.collect()
    torch.cuda.empty_cache()
    per = "; ".join(f"{s.split('_', 2)[-1]}: keyframes {r['meta']['n_keyframes']}, lost 0, ATE "
                    f"{r['ate']:.5f} m, {r['ms']:.2f} ms a frame, PSNR "
                    f"{r['meta']['metrics'].get('PSNR', float('nan')):.2f} dB"
                    for s, r in zip(scenes, runs))
    return (f"train_eval_all --datasets tum --extra \"{extra}\" over 3 scenes of "
            f"{MATRIX_FRAMES} frames {MATRIX_W}x{MATRIX_H} (written in {write_s:.1f} s): 3 "
            f"subprocesses of python -m artdeco_tpu_torch.run_system, exit 0, in {matrix_s:.1f} s; "
            f"{per}; {' '.join(cmds[0][3:7])} again in this process: {', '.join(rels)} "
            f"byte for byte the subprocess's, {run_s:.1f} s; {line}"), launches


def ab_phase(root: str) -> str:
    """15d: the rigid-transform A/B scripts on one image-folder scene, then
    both again: each must skip its finished scene."""
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset

    base, results = os.path.join(root, "base"), os.path.join(root, "ab_results")
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=AB_W),
                          n_frames=AB_FRAMES, width=AB_W, height=AB_H)
    write_stream(ds, os.path.join(base, "scene"))
    # the scripts call `python`: this interpreter, through a shim that
    # counts its calls
    bindir, log = os.path.join(root, "bin"), os.path.join(root, "python_calls.txt")
    os.makedirs(bindir)
    with open(os.path.join(bindir, "python"), "w") as f:
        f.write(f"#!/bin/bash\necho \"$*\" >> {log}\nexec {sys.executable} \"$@\" "
                + " ".join(SUBPROCESS_ARGS) + "\n")
    os.chmod(os.path.join(bindir, "python"), 0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}", BASE_DIR=base,
               RESULT_DIR=results)
    got, secs = {}, {}
    for kind in ("rigid", "norigid"):
        script = os.path.join(ROOT, "artdeco_tpu_torch", "scripts", f"run_debug_{kind}transform.sh")
        t0 = time.time()
        run_tool([script], env=env)
        secs[kind] = time.time() - t0
        got[kind] = run_dir_summary(os.path.join(results, "scene",
                                                 f"artdeco-tpu-torch-{kind}transform"))
    with open(log) as f:
        calls = f.read().splitlines()
    check(len(calls) == 2 and "--rigid_transform_gaussians" in calls[0]
          and "--no_rigid_transform_gaussians" in calls[1], f"phase 15d: python ran {calls}")
    for kind in ("rigid", "norigid"):
        script = os.path.join(ROOT, "artdeco_tpu_torch", "scripts", f"run_debug_{kind}transform.sh")
        res = run_tool([script], env=env)
        check(f"artdeco-tpu-torch-{kind}transform contains results" in res.stdout,
              f"phase 15d: the second {kind} run said {res.stdout!r}")
    with open(log) as f:
        check(len(f.read().splitlines()) == 2, "phase 15d: a second run started the entry point")
    a, b = (os.path.join(results, "scene", f"artdeco-tpu-torch-{k}transform")
            for k in ("rigid", "norigid"))
    differ = same_files(a, b, ["slam/frames.txt", "slam/keyframes.txt", "point_clouds/gs.ply"])
    n_kf = got["rigid"]["meta"]["n_keyframes"]
    return (f"run_debug_rigidtransform.sh and run_debug_norigidtransform.sh on one image folder "
            f"of {AB_FRAMES} frames {AB_W}x{AB_H} (no --oracle, no checkpoint: random "
            f"weights), exit 0 and metadata in {secs['rigid']:.1f} / {secs['norigid']:.1f} s, "
            f"{got['rigid']['ms']:.2f} / {got['norigid']['ms']:.2f} ms a frame, keyframes "
            f"{n_kf} / {got['norigid']['meta']['n_keyframes']}, lost share "
            f"{got['rigid']['lost']:.3f} / {got['norigid']['lost']:.3f}; trajectories and "
            + (f"scenes differ ({', '.join(differ)})" if differ else
               "scenes equal byte for byte: no loop-closure transform changed the scene")
            + "; a second invocation of each skipped its scene without starting python")


def tools_phase() -> int:
    """Phase 15: the tools (see the module docstring).  Returns the launches
    of 15c's in-process run."""
    import tempfile

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    line, images = rectify_line(root)
    print(f"phase 15a rectification: {line}", flush=True)
    print(f"phase 15b small tools: {small_tools_line(root, images)}", flush=True)
    line, launches = matrix_phase(root)
    print(f"phase 15c evaluation matrix: {line}", flush=True)
    print(f"phase 15d A/B scripts: {ab_phase(root)}", flush=True)
    print(f"phase 15 took {time.time() - t_phase:.1f} s", flush=True)
    return launches


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

    # -- 8. the full system ------------------------------------------------
    sys_launches, sys_ref = full_system_phase(dev, tcfg)
    for name in ("fwd", "bwd", "k3"):
        check(sys_launches[name] > 0, f"the full system launched no {name}")

    # -- 9. the solvers and relocalization -------------------------------------
    print(f"phase 9 solver golden: {solver_golden(dev)}", flush=True)
    print(f"phase 9 relocalization: {teleport_phase(dev, tcfg)}", flush=True)

    # -- 10. the model-driven system ----------------------------------------------
    print(f"phase 10 MASt3R: {mast3r_phase(dev, tcfg)}", flush=True)
    print(f"phase 10 Pi3: {pi3_phase(dev, tcfg)}", flush=True)
    model_summary, model_launches = model_system_phase(dev)
    print(f"phase 10 system: {model_summary}", flush=True)

    # -- 11. streams from disk ------------------------------------------------------
    disk_launches, disk_ref = disk_stream_phase(dev, tcfg, sys_ref)

    # -- 12. the side models and the keypoint-SfM bootstrap ---------------------------
    k3f, k3f_launches = side_models_phase(dev, tcfg, tds)

    # -- 13. the multi-device path ---------------------------------------------------
    mesh_launches = mesh_phase(dev, tcfg, sys_ref)

    # -- 14. the viewers ----------------------------------------------------------------
    view_launches = viewers_phase(dev, sys_ref, disk_ref)

    # -- 15. the tools ---------------------------------------------------------------------
    tools_launches = tools_phase()
    for name in ("fwd", "bwd", "k3"):
        check(tools_launches[name] > 0, f"phase 15c's run launched no {name}")

    # each path's own counts: the mapper stream (3), tracking (7), the oracle
    # system (8), the model-driven system (10), the streams from disk (11),
    # the System with the mesh (13d), the viewers (14a-c), the System
    # with the web viewer (14d) and the evaluation matrix's run in this
    # process (15c)
    by_phase = {"fwd": {"phase 3": launches["fwd"], "phase 8": sys_launches["fwd"],
                        "phase 10": model_launches["fwd"]},
                "bwd": {"phase 3": launches["bwd"], "phase 8": sys_launches["bwd"],
                        "phase 10": model_launches["bwd"]},
                "k3": {"phase 7": k3_launches, "phase 8": sys_launches["k3"],
                       "phase 10": model_launches["k3"]}}
    for part, counts in (*disk_launches.items(), ("phase 13d", mesh_launches),
                         *view_launches.items(), ("phase 15c", tools_launches)):
        for k in ("fwd", "bwd", "k3"):
            if k in counts:
                by_phase[k][part] = counts[k]
    src = "artdeco_tpu_torch/csrc/composite.cu"
    print(json.dumps({"kernels": [
        {"name": "composite_fwd", "route": "cuda", "source": src,
         "replaces": "artdeco_tpu/ops/splat/composite.py:113",
         "launches": sys_launches["fwd"], "launches_by_phase": by_phase["fwd"],
         "max_abs_err": big["fwd_err"],
         "ms": big["fwd_ms"], "plain_ms": big["fwd_plain_ms"],
         "bound_ms": big["fwd_bound"], "bound_by": big["fwd_by"], "library_ms": None},
        {"name": "composite_bwd", "route": "cuda", "source": src,
         "replaces": "artdeco_tpu/ops/splat/composite.py:152",
         "launches": sys_launches["bwd"], "launches_by_phase": by_phase["bwd"],
         "max_abs_err": big["bwd_err"],
         "ms": big["bwd_ms"], "plain_ms": big["bwd_plain_ms"],
         "bound_ms": big["bwd_bound"], "bound_by": big["bwd_by"], "library_ms": None},
        {"name": "window_argmax", "route": "cuda", "source": "artdeco_tpu_torch/csrc/refine.cu",
         "replaces": "artdeco_tpu/ops/refine_pallas.py:30",
         "launches": sys_launches["k3"], "launches_by_phase": by_phase["k3"],
         "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "window_argmax_f32", "route": "cuda",
         "source": "artdeco_tpu_torch/csrc/refine.cu",
         "replaces": "artdeco_tpu/ops/refine_pallas.py:30",
         "f32_path": "artdeco_tpu/ops/matching.py:325",
         "launches": k3f_launches, "launches_by_phase": {"phase 12f": k3f_launches},
         "max_abs_err": k3f["err"],
         "ms": k3f["ms"], "plain_ms": k3f["plain_ms"],
         "bound_ms": k3f["bound"], "bound_by": k3f["by"], "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
