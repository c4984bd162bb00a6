"""The port's Pi3 (``artdeco_tpu_torch/models/pi3.py``) and accurate loop
closure (``vslam/accurate_lc.py``) against the JAX package's, on the CPU, at
``tiny_pi3_config``.

Tolerances (the measured gaps in brackets): the position-embedding resize
within 5e-6 of ``jax.image.resize(..., "cubic")`` on unit-normal grids
[3.4e-6; the weights are JAX's, computed the same way in float32, and the
sums run in another order]; the float32 forward's ``points``,
``local_points``, ``conf`` and ``camera_poses`` within 1e-5 of their
largest magnitude through both weight routes (``synth_pi3_state_dict`` by
name, a flax ``init`` through ``state_dict_from_flax``) [5e-7]; in bf16
within 5e-3 of it [2.4e-3, on ``conf``]; rotations orthonormal and equal
from sign-flipped SVD factors; ``area_resize`` within 1e-6 of
``cv2.resize(INTER_AREA)`` when enlarging (384x512 -> 392x518, the
full-size path) and when shrinking [1.2e-7]; the accurate matcher's
fractions within 1e-3 (15 of 15,680 pixels) of the JAX matcher's on one
keyframe store [6.4e-5: one pixel].
"""

import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.models import pi3 as JP
from artdeco_tpu.models.convert_pi3 import convert_pi3_state_dict, synth_pi3_state_dict
from artdeco_tpu.vslam.accurate_lc import make_pi3_accurate_matcher as jmake
from artdeco_tpu.vslam.frame import Frame as JFrame
from artdeco_tpu.vslam.keyframes import KeyframeStore as JKeyframeStore
from artdeco_tpu_torch.models import pi3 as TP
from artdeco_tpu_torch.vslam import accurate_lc as TA
from artdeco_tpu_torch.vslam.frame import Frame
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from artdeco_tpu_torch.vslam.retrieval import build_retrieval_database
from torch_parity import CPU, n, t, torch_threads  # noqa: F401

MATCH = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-6, dist_thresh=0.1,
             radius=3, dilation_max=5)


def _close(got, want, rel, err=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * float(np.abs(want).max()), err_msg=err)


@pytest.mark.parametrize("nh,nw", [(28, 37), (8, 10), (37, 37), (40, 50)])
def test_pos_embed_resize_matches_jax(nh, nw):
    g = np.random.RandomState(0).randn(1, 37, 37, 16).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(g), (1, nh, nw, 16), "cubic"))
    got = TP.resize_pos_embed(t(g.reshape(1, -1, 16)), nh, nw)
    np.testing.assert_allclose(n(got).reshape(want.shape), want, rtol=0, atol=5e-6)


def _imgs():
    return np.random.RandomState(1).rand(1, 3, 3, 56, 70).astype(np.float32)


@pytest.mark.parametrize("route", ["state_dict", "flax_init"])
def test_pi3_forward_matches_jax(route):
    jcfg, tcfg = JP.tiny_pi3_config(compute_dtype=jnp.float32), TP.tiny_pi3_config(
        compute_dtype=torch.float32)
    imgs = _imgs()
    if route == "state_dict":
        sd = synth_pi3_state_dict(jcfg)
        params = convert_pi3_state_dict(sd, jcfg)
    else:
        params = JP.Pi3(jcfg).init(jax.random.PRNGKey(2), jnp.asarray(imgs))
        sd = TP.state_dict_from_flax(params, tcfg)
    want = JP.Pi3(jcfg).apply(params, jnp.asarray(imgs))
    with torch.no_grad():
        got = TP.load_pi3_state_dict(TP.Pi3(tcfg), sd)(t(imgs))
    for k in ("points", "local_points", "conf", "camera_poses"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(n(got[k]), want[k], 1e-5, k)


def test_pi3_forward_bf16_matches_jax():
    jcfg, tcfg = JP.tiny_pi3_config(), TP.tiny_pi3_config()
    sd = synth_pi3_state_dict(jcfg)
    want = JP.Pi3(jcfg).apply(convert_pi3_state_dict(sd, jcfg), jnp.asarray(_imgs()))
    model = TP.load_pi3_state_dict(TP.Pi3(tcfg), sd)
    assert model.decoder[0].attn.qkv.weight.dtype == torch.bfloat16
    assert model.decoder[0].ls1.gamma.dtype == torch.float32
    assert model.point_decoder.linear_out.weight.dtype == torch.float32
    with torch.no_grad():
        got = model(t(_imgs()))
    for k in ("points", "local_points", "conf", "camera_poses"):
        _close(n(got[k]), want[k], 5e-3, k)


def test_svd_orthogonalize_is_sign_free():
    """Rotations equal the JAX head's, and the same from SVD factors with
    flipped signs."""
    m = np.random.RandomState(3).randn(16, 3, 3).astype(np.float32)
    R = n(TP.svd_orthogonalize(t(m)))
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    mn = m / np.sqrt(np.sum(m * m, axis=-1, keepdims=True) + 1e-24)
    u, _, vh = np.linalg.svd(np.swapaxes(mn, -1, -2))
    flip = np.where(np.random.RandomState(4).rand(16, 1, 3) < 0.5, -1.0, 1.0)
    u, v = u * flip, np.swapaxes(vh, -1, -2) * flip
    ut = np.swapaxes(u, -1, -2)
    det = np.linalg.det(v @ ut)
    R2 = (v * np.stack([np.ones_like(det), np.ones_like(det), det], -1)[:, None, :]) @ ut
    np.testing.assert_allclose(R, R2, atol=1e-5)


def test_load_pi3_strict():
    cfg = TP.tiny_pi3_config()
    sd = synth_pi3_state_dict(JP.tiny_pi3_config())
    TP.load_pi3_state_dict(TP.Pi3(cfg), dict(sd, **{"encoder.mask_token": np.zeros(
        (1, 64), np.float32)}))
    missing = dict(sd)
    missing.pop("decoder.3.attn.k_norm.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        TP.load_pi3_state_dict(TP.Pi3(cfg), missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        TP.load_pi3_state_dict(TP.Pi3(cfg), dict(sd, enc2dec=np.zeros(3, np.float32)))


@pytest.mark.parametrize("src,dst", [((384, 512), (392, 518)), ((96, 128), (112, 140)),
                                     ((48, 64), (112, 140)), ((100, 130), (60, 70)),
                                     ((64, 96), (32, 48)), ((50, 60), (50, 60))])
def test_area_resize_matches_cv2(src, dst):
    img = np.random.RandomState(5).rand(*src, 3).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    got = n(TA.area_resize(t(img.transpose(2, 0, 1)), dst)).transpose(1, 2, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _stores(n_kf=4, h=48, w=64):
    """One keyframe store per package holding the same images."""
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset

    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=w), n_frames=12,
                          width=w, height=h)
    js, ts = JKeyframeStore(h, w, buffer=8), KeyframeStore(h, w, buffer=8, device=CPU)
    T = np.r_[0, 0, 0, 0, 0, 0, 1, 1].astype(np.float32)
    for k in range(n_kf):
        img = ds.transform.to_slam(ds[3 * k][0])
        js.append(JFrame(img=jnp.asarray(img), T_WC=jnp.asarray(T), X_canon=jnp.zeros((h * w, 3)),
                         C=jnp.ones((h * w, 1)), N=jnp.asarray(1), frame_id=k,
                         frame_time=float(k)))
        ts.append(Frame(img=t(img), T_WC=t(T), X_canon=torch.zeros(h * w, 3),
                        C=torch.ones(h * w, 1), N=torch.tensor(1), frame_id=k,
                        frame_time=float(k)))
    return js, ts


def test_accurate_matcher_matches_jax():
    """The same tiny float32 Pi3 weights behind both matchers, over one
    store: 3 candidates and the query, padded to 24 frames."""
    jcfg, tcfg = JP.tiny_pi3_config(compute_dtype=jnp.float32), TP.tiny_pi3_config(
        compute_dtype=torch.float32)
    sd = synth_pi3_state_dict(jcfg, seed=1)
    params = convert_pi3_state_dict(sd, jcfg)
    model = TP.load_pi3_state_dict(TP.Pi3(tcfg), sd)
    js, ts = _stores()
    jm = jmake(jax.jit(lambda x: JP.Pi3(jcfg).apply(params, x)), js, MATCH,
               resize_hw=(112, 140))
    tm = TA.make_pi3_accurate_matcher(torch.no_grad()(model), ts, MATCH, resize_hw=(112, 140))
    want = jm([0, 1, 2], 3)
    got = tm([0, 1, 2], 3)
    assert tm.calls == 1 and len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert all(0.0 <= f <= 1.0 for f in got)


def test_build_retrieval_database_wires_pi3(capsys):
    """``--accurate_loop_closure`` builds a live Pi3 matcher (random tiny
    weights without a checkpoint, with the JAX package's warning)."""
    args = types.SimpleNamespace(accurate_loop_closure=True, model_size="tiny",
                                 retrieval_checkpoint_path="", pi3_checkpoint_path="")
    cfg = {"retrieval": {"k": 3, "min_thresh": 5e-3, "accurate_min": 0.15}, "matching": MATCH}
    _, ts = _stores(3)
    db = build_retrieval_database(args, cfg, ts)
    assert "WARNING: no Pi3 checkpoint" in capsys.readouterr().out
    fracs = db.accurate_matcher([0, 1], 2)
    assert len(fracs) == 2 and all(0.0 <= f <= 1.0 for f in fracs)
    assert db.accurate_matcher.calls == 1
