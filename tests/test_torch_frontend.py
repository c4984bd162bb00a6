"""The ported tracking slice against the JAX frontend, end to end on the CPU.

The same ``SyntheticDataset`` stream (128x96, every 4th frame of a
96-frame clip, so 24 tracked frames of 4.1 px motion each) runs through
the JAX ``Frontend`` + ``OracleRunner`` and through the port's, with
``config/base.yaml`` as it is (matching radius 4, dilation 5, LM and
tracking blocks unchanged).  The JAX side makes its second keyframe at
tracked frame 21 (stream frame 84).

Tolerances: keyframe and mapper-frame decisions identical; match indices
equal on >= 99.9 % of the pixels both sides call valid (iter_proj's f32
differences, see test_torch_matching.py, leave a few truncated positions
on the other side of a pixel edge; refine snaps almost all back); pose
translations within 1e-4 (measured <= 1.4e-5); ATE RMSE within 1e-4 m of
the JAX package's.  Host-side copies (oracle geometry, config, TUM IO,
trajectory evaluation, ``to_slam`` at the SLAM size) are held exactly.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.dataio import tum_io as jtum
from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.eval import trajectory as jtraj
from artdeco_tpu.models.oracle import OracleRunner as JOracleRunner
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu.vslam.frontend import Frontend as JFrontend
from artdeco_tpu.vslam.keyframes import KeyframeStore as JKeyframeStore
from artdeco_tpu_torch.dataio import tum_io
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.eval import trajectory
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu_torch.vslam.frame import KeyframeStyle
from artdeco_tpu_torch.vslam.frontend import Frontend
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from artdeco_tpu_torch.vslam.state_io import frontend_state_from_numpy, load_frontend_state
from torch_parity import CPU, jax_frontend_state, n, t, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, STRIDE, N_TRACKED, SNAP = 128, 96, 4, 24, 16
ARGS = types.SimpleNamespace(test_hold=-1, max_size_slam=W)
FRAMES = list(range(0, STRIDE * N_TRACKED, STRIDE))
CFG = os.path.join(REPO, "config", "base.yaml")


def gt_pose(ds, i):
    T = np.ones(8, np.float32)
    T[:7] = ds.Twc_gt[i]
    return T


def ate(traj_mod, fe):
    est, gt = fe.estimated_trajectory(), np.asarray(fe.frames_Twc_gt)
    return traj_mod.evaluate_trajectory("", "unused.json", est, gt, max_dt=0.05)["APE"]["rmse"]


def frame_record(fe, msg):
    """(style, is_important, match idx, valid, T_WC) of the frame just
    processed; idx/valid are None for frame 0 (no match)."""
    pair = msg["track_match"] if msg and msg.get("track_match") else fe.tracker._last_pair
    idx = valid = None
    if pair is not None and pair["kind"] == "pair":
        idx, valid = n(pair["idx"]).ravel(), n(pair["valid"]).ravel()
    style = None if msg is None else msg["keyframe_style"]
    imp = None if msg is None else msg["is_important"]
    return style, imp, idx, valid, n(fe.last_T_WC).copy()


@pytest.fixture(scope="module")
def jax_run():
    jds = JSyntheticDataset(types.SimpleNamespace(**vars(ARGS)), n_frames=STRIDE * N_TRACKED,
                            width=W, height=H)
    cfg = jload_config(CFG)
    runner = JOracleRunner((jds.H_slam, jds.W_slam), jds.K_slam, cfg["matching"])
    for i in FRAMES:
        runner.register(jds.transform.to_slam(jds[i][0]), i, gt_pose(jds, i))
    fe = JFrontend(ARGS, cfg, jds, JKeyframeStore(jds.H_slam, jds.W_slam, jds.K_slam, buffer=64),
                   runner)
    records, snap = [], None
    for k, i in enumerate(FRAMES):
        img, info = jds[i]
        records.append(frame_record(fe, fe.process_frame(img, info)))
        if k == SNAP:
            snap = jax_frontend_state(fe)
    return types.SimpleNamespace(records=records, snap=snap, ate=ate(jtraj, fe),
                                 lost=fe.lost_number, n_kf=len(fe.keyframes), runner=runner,
                                 T_WC=fe.keyframes.T_WC[:len(fe.keyframes)].copy())


def port_frontend():
    ds = SyntheticDataset(ARGS, n_frames=STRIDE * N_TRACKED, width=W, height=H)
    cfg = load_config(CFG)
    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=CPU)
    for i in FRAMES:
        runner.register(ds.transform.to_slam(ds[i][0]), i, gt_pose(ds, i))
    store = KeyframeStore(ds.H_slam, ds.W_slam, ds.K_slam, buffer=64, device=CPU)
    return ds, Frontend(ARGS, cfg, ds, store, runner, device=CPU)


def check_frame(k, got, want):
    style, imp, idx, valid, T = got
    jstyle, jimp, jidx, jvalid, jT = want
    assert (style, imp) == (jstyle, jimp), (k, style, jstyle, imp, jimp)
    if jidx is not None:
        assert (valid == jvalid).mean() >= 0.999, k
        both = valid & jvalid
        assert (idx[both] == jidx[both]).mean() >= 0.999, (k, (idx[both] == jidx[both]).mean())
    np.testing.assert_allclose(T[:3], jT[:3], atol=1e-4, err_msg=f"frame {k}")


def test_frontend_slice_matches_jax(jax_run):
    styles = [r[0] for r in jax_run.records]
    first_kf = [k for k, s in enumerate(styles) if s == int(KeyframeStyle.KEYFRAME) and k > 0]
    assert first_kf and first_kf[0] <= 32, styles     # the stream makes a keyframe

    ds, fe = port_frontend()
    for k, i in enumerate(FRAMES):
        img, info = ds[i]
        check_frame(k, frame_record(fe, fe.process_frame(img, info)), jax_run.records[k])
    assert fe.lost_number == jax_run.lost == 0
    assert len(fe.keyframes) == jax_run.n_kf >= 2
    np.testing.assert_allclose(fe.keyframes.T_WC[:len(fe.keyframes)], jax_run.T_WC, atol=1e-4)
    port_ate = ate(trajectory, fe)
    assert abs(port_ate - jax_run.ate) < 1e-4, (port_ate, jax_run.ate)
    assert port_ate < 0.03
    assert fe.runner.d2h_lookups == 0


def test_frontend_resumes_from_jax_state(jax_run):
    """The port picks up the JAX frontend's state after tracked frame SNAP
    and tracks the rest of the stream (through the keyframe) alike."""
    ds, fe = port_frontend()
    load_frontend_state(fe, frontend_state_from_numpy(jax_run.snap, CPU))
    assert fe.frame_id == SNAP + 1 and len(fe.keyframes) == 1
    for k in range(SNAP + 1, N_TRACKED):
        img, info = ds[FRAMES[k]]
        check_frame(k, frame_record(fe, fe.process_frame(img, info)), jax_run.records[k])
    assert len(fe.keyframes) == jax_run.n_kf


def test_oracle_runner_matches_jax(jax_run):
    jr = jax_run.runner
    ds, fe = port_frontend()
    tr = fe.runner
    for fid in (0, FRAMES[5]):
        np.testing.assert_array_equal(tr._pointmap(fid), jr._pointmap(fid))
        np.testing.assert_array_equal(tr._desc(fid), jr._desc(fid))
    img = ds.transform.to_slam(ds[FRAMES[5]][0])
    dev = torch.from_numpy(img)
    tr.bind(dev, img)
    assert tr._fid(dev) == jr._fid(jnp.asarray(img)) == FRAMES[5]
    assert tr.d2h_lookups == 0
    X, C, feat, _ = tr.inference_mono(dev)
    jX, jC, jfeat, _ = jr.inference_mono(jnp.asarray(img))
    np.testing.assert_array_equal(n(X), n(jX))
    np.testing.assert_array_equal(n(C), n(jC))
    assert tr._fid_from_feat(feat) == jr._fid_from_feat(jfeat) == FRAMES[5]
    kf_emb = tr._token(0)
    out = tr.match_asymmetric(dev, None, embeddings_j=kf_emb)
    jout = jr.match_asymmetric(jnp.asarray(img), None,
                               embeddings_j=(jnp.asarray(n(kf_emb[0])), None))
    assert (n(out[0]) == n(jout[0])).mean() >= 0.999
    assert (n(out[1]) == n(jout[1])).mean() >= 0.999
    for k in (2, 3, 4, 6, 7):
        np.testing.assert_array_equal(n(out[k]), n(jout[k]))
    np.testing.assert_allclose(n(out[5]), n(jout[5]), atol=1e-6)   # on-device Sim(3)


def test_host_copies_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)        # base_outdoor.yaml inherits by a relative path
    for name in ("base.yaml", "base_outdoor.yaml"):
        assert load_config(f"config/{name}") == jload_config(f"config/{name}")
    rng = np.random.RandomState(0)
    ts = np.arange(40) * 0.5
    gt = np.concatenate([ts[:, None], rng.randn(40, 3).cumsum(0),
                         np.tile([0, 0, 0, 1.0], (40, 1))], 1)
    est = gt.copy()
    est[:, 1:4] = 1.3 * est[:, 1:4] + 0.01 * rng.randn(40, 3)
    est[:, 0] += 0.01 * rng.randn(40)
    assert trajectory.evaluate_trajectory("", "x.json", est, gt) == \
        jtraj.evaluate_trajectory("", "x.json", est, gt)
    np.testing.assert_array_equal(tum_io.associate_trajectories(est[:, 0], gt[:, 0], 0.02),
                                  jtum.associate_trajectories(est[:, 0], gt[:, 0], 0.02))
    tum_io.save_tum_trajectory(tmp_path / "a.txt", est[:, 0], est[:, 1:])
    jtum.save_tum_trajectory(tmp_path / "b.txt", est[:, 0], est[:, 1:])
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    np.testing.assert_array_equal(tum_io.load_tum_trajectory(tmp_path / "a.txt"),
                                  jtum.load_tum_trajectory(tmp_path / "b.txt"))


@pytest.mark.parametrize("width,height,size", [(128, 96, 128), (512, 384, 512), (200, 150, 128)])
def test_to_slam_matches_jax(width, height, size):
    args = types.SimpleNamespace(test_hold=-1, max_size_slam=size)
    ds = SyntheticDataset(args, n_frames=2, width=width, height=height)
    jds = JSyntheticDataset(types.SimpleNamespace(**vars(args)), n_frames=2, width=width,
                            height=height)
    a, b = ds.transform.to_slam(ds[1][0]), jds.transform.to_slam(jds[1][0])
    assert a.shape == b.shape == (3, ds.H_slam, ds.W_slam) and a.dtype == b.dtype
    if size == width:       # no resampling: the same bytes, which key the oracle
        np.testing.assert_array_equal(a, b)
    else:                   # PyTorch's area filter against OpenCV's
        assert np.abs(a - b).mean() < 0.05
