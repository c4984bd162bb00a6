"""The port's tracker, frame and keyframe store against the JAX package's.

Tolerances, all float32 on the CPU:

* ``masked_quantile`` and the keyframe tests: a sort and counts, so the
  values are equal up to 1e-6 and the decisions identical.
* the LMs: both recover the poses of tests/test_tracker.py to the same
  bounds; against each other the solved poses agree within 1e-5 in the
  Sim(3) log (summation order in the 7x7 normal equations differs
  between XLA and torch by f32 ulps; the converged poses do not see it).
  With the focal free and the covariance gate on, 1e-4 and the focal
  within 1e-3 px: the gate thresholds a quantile of 3x3 determinants,
  where an ulp can move a point across it.
* ``track_step``: fused pointmaps within 1e-5, pose within 1e-5 in the
  Sim(3) log, the three decisions equal, the match fraction to 1e-6 (a
  mean in another order) and the quantile distance to 1e-4 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.ops import matching as jm
from artdeco_tpu.vslam import tracker as jtrk
from artdeco_tpu.vslam.frame import Frame as JFrame
from artdeco_tpu.vslam.keyframes import KeyframeStore as JKeyframeStore
from artdeco_tpu_torch.geometry import lie, projection as proj
from artdeco_tpu_torch.vslam import tracker as trk
from artdeco_tpu_torch.vslam.frame import Frame
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from artdeco_tpu_torch.vslam.tracker import TrackingConfig
from test_torch_matching import MATCH_CFG, oracle_pair
from torch_parity import CPU, n, t, torch_threads  # noqa: F401

H, W = 48, 64
K = np.asarray([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]], np.float32)


def scene():
    """tests/test_tracker.py's wavy surface, in the keyframe camera."""
    uv = proj.get_pixel_coords((H, W), device=CPU)
    z = 2.0 + 0.4 * torch.sin(uv[:, 0] / 9.0) + 0.3 * torch.cos(uv[:, 1] / 7.0)
    return proj.backproject(uv, z[:, None], t(K))


def log_err(Ta, Tb):
    """|log(Ta^-1 Tb)| of two Sim(3) poses (float64)."""
    Ta, Tb = t(n(Ta)).double(), t(n(Tb)).double()
    return float(torch.linalg.vector_norm(lie.sim3_log(lie.sim3_mul(lie.sim3_inv(Ta), Tb))))


def test_masked_quantile_and_config_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(100).astype(np.float32)
    for mask in (rng.rand(100) > 0.3, np.zeros(100, bool), np.eye(1, 100, 7, dtype=bool)[0]):
        for q in (0.0, 0.5, 0.9, 1.0):
            a = trk.masked_quantile(t(x), t(mask), q)
            b = jtrk.masked_quantile(jnp.asarray(x), jnp.asarray(mask), q)
            np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    assert TrackingConfig._fields == jtrk.TrackingConfig._fields
    assert TrackingConfig._field_defaults == jtrk.TrackingConfig._field_defaults


def test_check_keyframe_and_keyframe_map_match_jax():
    rng = np.random.RandomState(1)
    nn = H * W
    idx_id = np.arange(nn)
    uv = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    idx_shift = np.clip(uv[:, 0] + 40, 0, W - 1) + W * uv[:, 1]
    few = np.zeros((nn, 1), bool)
    few[: nn // 10] = True
    cases = [(idx_id, np.ones((nn, 1), bool)), (np.zeros(nn, np.int64), np.ones((nn, 1), bool)),
             (idx_id, few), (idx_shift, rng.rand(nn, 1) > 0.5),
             (rng.randint(0, nn, nn), rng.rand(nn, 1) > 0.2)]
    for idx, valid in cases:
        a = trk.check_keyframe(t(idx), t(valid[:, 0]), t(valid), 0.333)
        b = jtrk.check_keyframe(jnp.asarray(idx), jnp.asarray(valid[:, 0]), jnp.asarray(valid),
                                0.333)
        assert bool(a) == bool(b)
        for last in (0.0, 12.5):
            ka, da = trk.check_keyframe_map(t(idx), t(valid), W, H, 0.5, last, 30.0)
            kb, db = jtrk.check_keyframe_map(jnp.asarray(idx), jnp.asarray(valid), W, H, 0.5,
                                             jnp.asarray(last), 30.0)
            assert bool(ka) == bool(kb)
            np.testing.assert_allclose(float(da), float(db), atol=1e-6)
    # the JAX test's own expectations
    assert not bool(trk.check_keyframe(t(idx_id), t(np.ones(nn, bool)),
                                       t(np.ones((nn, 1), bool)), 0.333))
    is_kf2, dq2 = trk.check_keyframe_map(t(idx_shift), t(np.ones((nn, 1), bool)), W, H, 0.5,
                                         0.0, 30.0)
    assert bool(is_kf2) and float(dq2) > 30.0


def test_opt_pose_ray_dist_recovers_pose_as_jax():
    Xk = scene()
    xi = t(np.asarray([0.05, -0.02, 0.03, 0.01, -0.02, 0.015, 0.02], np.float32))
    T_true = lie.sim3_exp(xi)
    Xf = lie.sim3_act(lie.sim3_inv(T_true), Xk)
    I8 = lie.sim3_identity(device=CPU)
    Q = torch.full((H * W, 1), 4.0)
    valid = torch.ones((H * W, 1), dtype=torch.bool)
    cfg = TrackingConfig(max_iters=50, rel_error=0.0, delta_norm=1e-7)
    _, T_CkCf, ok = trk.opt_pose_ray_dist_sim3(Xf, Xk, I8, I8, Q, valid, cfg)
    assert bool(ok)
    assert log_err(T_CkCf, T_true) < 1e-4
    _, jT, jok = jtrk.opt_pose_ray_dist_sim3(*map(jnp.asarray, (n(Xf), n(Xk), n(I8), n(I8),
                                                               n(Q), n(valid))), cfg)
    assert bool(jok) and log_err(T_CkCf, jT) < 1e-5


@pytest.mark.parametrize("focal_cov", [False, True])
def test_opt_pose_calib_recovers_pose_as_jax(focal_cov):
    Xk = scene()
    xi = t(np.asarray([0.04, -0.03, 0.05, 0.015, -0.01, 0.02, -0.02], np.float32))
    if focal_cov:
        xi = 0.5 * xi
    T_true = lie.sim3_exp(xi)
    idx = torch.arange(H * W)
    C = torch.full((H * W, 1), 2.0)
    Xf_in = lie.sim3_act(lie.sim3_inv(T_true), Xk) if focal_cov else Xk
    _, Xf_cov, Xk_c, _, _, _, meas_k, valid_meas = trk.prep_track_measurements(
        Xf_in, Xk, C, C, idx, t(K), (H, W))
    j_prep = jtrk.prep_track_measurements(jnp.asarray(n(Xf_in)), jnp.asarray(n(Xk)),
                                          jnp.asarray(n(C)), jnp.asarray(n(C)),
                                          jnp.asarray(n(idx)), jnp.asarray(K), (H, W))
    for a, b in zip((Xf_cov, Xk_c, meas_k, valid_meas), (j_prep[1], j_prep[2], j_prep[6],
                                                          j_prep[7])):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5, rtol=1e-5)
    Xf = lie.sim3_act(lie.sim3_inv(T_true), Xk_c)
    Q = torch.full((H * W, 1), 4.0)
    valid = torch.ones((H * W, 1), dtype=torch.bool)
    I8 = lie.sim3_identity(device=CPU)
    cfg = (TrackingConfig(max_iters=30) if focal_cov
           else TrackingConfig(max_iters=50, rel_error=0.0, delta_norm=1e-8))
    kw = dict(optimize_focal=focal_cov, covariance_filter=focal_cov)
    args = (Xf, Xf_cov, Xk_c, I8, I8, Q, valid, meas_k, valid_meas, idx, t(K), (H, W), cfg)
    _, T_CkCf, K_out, ok = trk.opt_pose_calib_sim3(*args, **kw)
    assert bool(ok)
    _, jT, jK, jok = jtrk.opt_pose_calib_sim3(
        *[jnp.asarray(n(a)) for a in args[:11]], (H, W), cfg, **kw)
    assert bool(jok)
    if focal_cov:
        assert log_err(T_CkCf, T_true) < 5e-2 and abs(float(K_out[0, 0]) - 60.0) < 3.0
        np.testing.assert_allclose(n(K_out), n(jK), atol=1e-3)
        assert log_err(T_CkCf, jT) < 1e-4
    else:
        assert log_err(T_CkCf, T_true) < 1e-3
        np.testing.assert_array_equal(n(K_out), K)
        assert log_err(T_CkCf, jT) < 1e-5


def test_tracking_failure_detected():
    """Degenerate (all-zero) inputs set ok=False, as in the JAX package, and
    a finite but singular system is caught through cholesky_ex's info."""
    N = H * W
    zeros = torch.zeros((N, 3))
    I8 = lie.sim3_identity(device=CPU)
    cfg = TrackingConfig(max_iters=5)
    _, _, ok = trk.opt_pose_ray_dist_sim3(zeros, zeros, I8, I8, torch.zeros((N, 1)),
                                          torch.zeros((N, 1), dtype=torch.bool), cfg)
    assert not bool(ok)
    # rank-deficient J (one column only): H is finite and singular
    J = torch.zeros((N, 3, 7))
    J[:, :, 0] = 1.0
    r = torch.ones((N, 3))
    tau, cost, ok = trk._solve_gn(torch.ones((N, 3)), r, J, 1.345)
    jtau, jcost, jok = jtrk._solve_gn(jnp.ones((N, 3)), jnp.asarray(n(r)), jnp.asarray(n(J)),
                                      1.345)
    assert not bool(ok) and not bool(jok)
    assert torch.all(tau == 0) and float(cost) == pytest.approx(float(jcost))


def test_track_step_matches_jax():
    """One fused tracking step on an oracle pair (frame 3 stream frames
    from the keyframe), with the JAX package's own matches as input."""
    X11, X21, D11, D21 = oracle_pair(H, W, shift=3)
    idx, valid = jm.match(MATCH_CFG, *map(jnp.asarray, (X11, X21, D11, D21)))
    hw = H * W
    rng = np.random.RandomState(2)
    Xff = X11.reshape(hw, 3)
    Xkf = X21.reshape(hw, 3)
    C = np.full((hw, 1), 5.0, np.float32)
    fX = (Xff * (1 + 0.01 * rng.randn(hw, 1))).astype(np.float32)
    T_WCk = np.asarray([0.1, 0, 0, 0, 0, 0, 1, 1], np.float32)
    T_WCf = np.asarray([0.1, 0.01, 0, 0, 0, 0, 1, 1], np.float32)
    Kn = np.asarray([[0.8 * W, 0, (W - 1) / 2], [0, 0.8 * W, (H - 1) / 2], [0, 0, 1]],
                    np.float32)
    cfg = TrackingConfig(point_stride=4)
    common = dict(min_displacement=30.0, img_size=(H, W), cfg=cfg)
    ins = [Xff, C, fX, C, np.int32(1), Xkf, C, Xkf, 2 * C, np.int32(2), np.asarray(idx),
           np.asarray(valid), C, C, T_WCf, T_WCk, Kn]
    out = trk.track_step(*[t(a) for a in ins], 0.0, **common)
    jout = jtrk.track_step(*[jnp.asarray(a) for a in ins], jnp.asarray(0.0, jnp.float32),
                           **common)
    for k in (0, 1, 6, 7):          # fused pointmaps and confidences
        np.testing.assert_allclose(n(out[k]), n(jout[k]), atol=1e-5, rtol=1e-5)
    assert int(out[2]) == int(jout[2]) and int(out[8]) == int(jout[8])
    assert log_err(out[3], jout[3]) < 1e-5 and log_err(out[4], jout[4]) < 1e-5
    np.testing.assert_array_equal(n(out[9])[1:4], n(jout[9])[1:4])
    assert abs(float(out[9][0]) - float(jout[9][0])) < 1e-6     # a mean over pixels
    assert abs(float(out[9][4]) - float(jout[9][4])) < 1e-4
    assert float(out[9][1]) == 1.0 and float(out[9][0]) > 0.5


def test_frame_fusion_and_keyframe_store():
    img = torch.zeros((3, 4, 4))
    f = Frame.create(img)
    jf = JFrame.create(jnp.zeros((3, 4, 4)))
    for X, C in ((np.ones((16, 3)), np.full((16, 1), 2.0)),
                 (np.full((16, 3), 4.0), np.full((16, 1), 6.0))):
        f = f.update_pointmap(t(X, torch.float32), t(C, torch.float32))
        jf = jf.update_pointmap(jnp.asarray(X, jnp.float32), jnp.asarray(C, jnp.float32))
        np.testing.assert_allclose(n(f.X_canon), n(jf.X_canon))
        assert int(f.N) == int(jf.N) and f.N.dtype == torch.int32
    np.testing.assert_allclose(n(f.X_canon), np.full((16, 3), 3.25))
    np.testing.assert_allclose(n(f.get_average_conf()), np.full((16, 1), 4.0))

    store = KeyframeStore(4, 4, K_slam=np.eye(3), buffer=8, device=CPU)
    jstore = JKeyframeStore(4, 4, K_slam=np.eye(3), buffer=8)
    img = torch.arange(48, dtype=torch.float32).reshape(3, 4, 4)
    g = Frame.create(img, frame_id=7, frame_time=1.25).update_pointmap(
        torch.ones((16, 3)), torch.full((16, 1), 2.0))
    assert store.append(g) == jstore.append(JFrame.create(jnp.asarray(n(img)), 7, 1.25)) == 0
    h = store[0]
    assert len(store) == 1 and h.frame_id == 7 and h.frame_time == 1.25
    np.testing.assert_allclose(n(h.img), n(img))
    np.testing.assert_allclose(n(h.X_canon), n(g.X_canon))
    for s in (store, jstore):
        s.update_T_WCs(np.tile([1, 2, 3, 0, 0, 0, 1, 1], (1, 1)), [0])
        assert s.get_dirty_idx().tolist() == [0] and s.get_dirty_idx().tolist() == []
    np.testing.assert_allclose(n(store[0].T_WC), n(jstore[0].T_WC))
    store.update_payload(0, g.X_canon * 2, g.C, g.N)
    assert store.version[0] == 2 and store.get_dirty_idx().tolist() == [0]
    store.put_embedding(0, "feat", "pos")
    assert store.get_embedding(0) == ("feat", "pos")
    store.pop_last()
    assert len(store) == 0 and store.last_keyframe() is None and store.get_embedding(0) is None
