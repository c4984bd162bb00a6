"""Warm per-stage timing of the streaming pipeline on the card.

Port of ``scripts/profile_stages.py`` (``device`` "cpu" runs it on the
CPU): streams the oracle pipeline sequentially over 24 frames of a
1024x576 synthetic stream (SLAM 512x288; every stage runs once, the state
fills), then times each stage alone, the device synchronised around each
window:

  * raw costs: a scalar read-back, a 3x288x512 float32 upload, a 288x512x3
    float32 read-back
  * one tracking match (``match_asymmetric``, the cascade at b = 1 with the
    oracle's glue) and the fused ``track_step``
  * the symmetric match at b = 1, 2, 4 (the backend's ``add_factors`` cost
    a keyframe), and the cascade's parts at b = 1, 2, 4, 8: ``iter_proj``,
    the refine (K3, one launch a row) and the whole cascade
  * one GN solve at the graph's current size
  * one mapper iteration (``optimization_step``), a 20-iteration burst, a
    full-resolution render and one densify (``add_new_gaussians``)

Rows are timed by CUDA events over back-to-back calls (``bench.time_ms``)
and name the card and its power limit.  ``repeats`` scales every row's
count of calls (JAX's 8, 4 and 2; at least one).

Usage:
  python -m artdeco_tpu_torch.scripts.profile_stages
"""

import argparse
import time

import numpy as np
import torch

from artdeco_tpu_torch.bench import card_label, log, oracle_system, sync, time_ms
from artdeco_tpu_torch.device import resolve


def stage_mapper_config():
    """The JAX script's mapper sizes (a 2^14 starting slab, growing)."""
    from artdeco_tpu_torch.mapper.config import MapperConfig

    return MapperConfig(
        capacity=1 << 18, initial_capacity=1 << 14, new_budget=1 << 14,
        cluster_capacity=1 << 13, voxel_table_size=1 << 16,
        keyframe_capacity=256, sh_degree=3, local_feat_dim=16,
        global_feat_dim=16, pyr_levels=2, gs_add_ratio=1.0,
        init_proba_scaler=4.0,
    )


def main(device=None, n_frames: int = 24, width: int = 1024, height: int = 576,
         repeats: float = 1.0) -> dict:
    """Warm on ``n_frames`` (at least 4; the tracking rows use frames
    n - 4, n - 3 and n - 2, the JAX script's 20, 21 and 22 of 24) and
    profile on ``device`` (default: the card); returns {row: ms} and the
    state's sizes."""
    from artdeco_tpu_torch.ops import matching as M
    from artdeco_tpu_torch.vslam import tracker as trk
    from artdeco_tpu_torch.vslam.frame import Frame

    dev = resolve(device)
    if n_frames < 4:
        raise ValueError(f"profile_stages needs at least 4 frames, got {n_frames}")
    system, dataset, runner, config = oracle_system(n_frames, width, height,
                                                    stage_mapper_config(), dev)
    label = card_label(str(dev))

    log(f"warming: streaming {n_frames} frames (sequential) [{label}]...")
    t0 = time.time()
    for i in range(n_frames):
        img, info = dataset[i]
        msg = system.frontend.process_frame(img, info)
        if msg is not None:
            work = system.backend.process_sync(msg)
            if work is not None:
                mm = system.backend.process_async(work)
                if mm is not None:
                    system._handle_mapper_msg(mm)
        system.n_frames += 1
    sync(dev)
    sm = system.scene_model
    fg = system.backend.factor_graph
    tracker = system.frontend.tracker
    rows = {"keyframes": len(system.keyframes), "gaussians": sm.n_active_gaussians}
    log(f"warm done in {time.time() - t0:.0f}s, kf={rows['keyframes']}, "
        f"gs={rows['gaussians']}")

    def row(name, fn, n):
        rows[name] = time_ms(fn, max(1, round(n * repeats)), dev)
        log(f"  {name}: {rows[name]:.3f} ms")

    h, w = dataset.H_slam, dataset.W_slam

    # ---- raw transfer costs ------------------------------------------------
    one = torch.zeros((), device=dev)
    t0 = time.perf_counter()
    for _ in range(20):
        float(one)
    rows["scalar sync round-trip"] = 1e3 * (time.perf_counter() - t0) / 20
    img_host = np.random.RandomState(0).rand(3, h, w).astype(np.float32)

    def h2d():
        torch.from_numpy(img_host).to(dev)
        sync(dev)
    dev_map = torch.zeros((h, w, 3), device=dev)
    rows[f"h2d 3x{h}x{w} + sync"] = time_ms(h2d, 8, dev)
    rows[f"d2h {h}x{w}x3"] = time_ms(lambda: dev_map.cpu(), 8, dev)
    log(f"  scalar sync round-trip: {rows['scalar sync round-trip']:.3f} ms")
    log(f"  h2d 3x{h}x{w} ({img_host.nbytes / 1e6:.2f} MB) + sync: "
        f"{rows[f'h2d 3x{h}x{w} + sync']:.3f} ms")
    log(f"  d2h {h}x{w}x3 ({dev_map.numel() * 4 / 1e6:.2f} MB): {rows[f'd2h {h}x{w}x3']:.3f} ms")

    # ---- tracking stage ----------------------------------------------------
    fa, fb, fc = n_frames - 4, n_frames - 3, n_frames - 2
    kf_idx = system.keyframes.last_index()
    keyframe = system.keyframes[kf_idx]
    host_c = dataset.transform.to_slam(dataset[fc][0])
    slam_c = torch.as_tensor(np.ascontiguousarray(host_c), device=dev)
    runner.bind(slam_c, host_c)

    def match_asym():
        return runner.match_asymmetric(slam_c, keyframe.img,
                                       embeddings_j=tracker.last_embedding)
    row("match_asymmetric (cascade b=1, incl oracle glue)", match_asym, 8)

    fr = Frame.create(slam_c, frame_id=fc, frame_time=float(fc),
                      T_WC=torch.as_tensor(system.keyframes.T_WC[kf_idx], device=dev))
    (idx_f2k, vmk, Xff, Cff, Qff, Xkf, Ckf, Qkf, _, _) = match_asym()
    row("track_step (fused LM + gates)", lambda: trk.track_step(
        Xff, Cff, fr.X_canon, fr.C, fr.N, Xkf, Ckf, keyframe.X_canon, keyframe.C,
        keyframe.N, idx_f2k, vmk, Qff, Qkf, fr.T_WC, keyframe.T_WC, tracker.K_slam, 0.0,
        float(tracker.min_displacement), (h, w), tracker.cfg,
        thres_keyframe=float(tracker.thres_keyframe), optimize_focal=tracker.optimize_focal,
        covariance_filter=tracker.covariance_filter), 8)

    # ---- backend stages ----------------------------------------------------
    for b in (1, 2, 4):
        ids_i = [max(0, kf_idx - 1 - j) for j in range(b)]
        emb = system.keyframes.get_embedding
        feat_i = torch.cat([emb(i)[0] for i in ids_i])
        pos_i = torch.cat([emb(i)[1] for i in ids_i])
        feat_j = torch.cat([emb(kf_idx)[0]] * b)
        pos_j = torch.cat([emb(kf_idx)[1]] * b)
        row(f"match_symmetric b={b} ({2 * b} cascades)",
            lambda: runner.match_symmetric(feat_i, pos_i, feat_j, pos_j, (h, w)), 8)

    # ---- the cascade's parts against the batch -------------------------------
    f0, f1 = runner._dev(fa), runner._dev(fb)
    n_hw = h * w
    cfg_m = config["matching"]
    for b in (1, 2, 4, 8):
        X11 = torch.stack([f0[0].reshape(h, w, 3)] * b)
        X21 = torch.stack([runner._cross_dev(fb, fa).reshape(h, w, 3)] * b)
        D11 = torch.stack([f0[1].reshape(h, w, -1)] * b)
        D21f = torch.stack([f1[1]] * b)
        rwg, ptn, pin = M.prep_for_iter_proj(X11, X21, None)
        row(f"iter_proj b={b}", lambda: M.iter_proj(rwg, ptn, pin, max_iter=10), 4)
        vv, uu = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        p_dummy = torch.stack([uu, vv], -1).reshape(1, n_hw, 2).expand(b, n_hw, 2) \
            .to(torch.int32).contiguous()
        row(f"refine_dense b={b}", lambda: M.refine_matches(
            D11, D21f, p_dummy, radius=4, dilation_max=5, compute_dtype=torch.bfloat16), 4)
        D21img = D21f.reshape(b, h, w, -1)
        row(f"full cascade b={b}", lambda: M.match(cfg_m, X11, X21, D11, D21img, None), 4)

    rows["gn_graph"] = f"{len(fg.ii)} pairs, {fg.n_directed} directed"
    row("GN solve", fg.solve_GN_calib, 4)
    log(f"    (current graph: {rows['gn_graph']})")

    # ---- mapper ------------------------------------------------------------
    rows["slab_capacity"] = sm.slab.capacity
    log(f"  [gaussians active: {sm.n_active_gaussians}, slab capacity: {sm.slab.capacity}]")
    row("mapper single iteration", lambda: sm.optimization_step(is_important=True), 4)
    row("mapper 20-iteration burst", lambda: sm.optimization_loop(20, is_important=True), 2)
    row("render_from_id (full res, fwd only)",
        lambda: sm.render_from_id(len(sm.keyframes) - 1), 4)
    row("densify (add_new_gaussians)", lambda: sm.add_new_gaussians(len(sm.keyframes) - 1), 2)
    rows["gaussians_after"] = sm.n_active_gaussians
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
