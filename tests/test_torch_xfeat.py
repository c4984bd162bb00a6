"""The port's XFeat (``artdeco_tpu_torch/models/xfeat.py``) against the JAX
package's, on the CPU, at XFeat's only width (64-d descriptors, 65-channel
keypoint logits).

Weights: a release-layout state dict with seeded random values (conv
kernels scaled by 1 / sqrt(fan-in), running variances in [0.5, 1]) goes
to JAX through its converter and into the port strictly.

Tolerances (the measured gaps in brackets): the backbone's three outputs
within 1e-5 of their largest magnitude, at both ``block3_stride``s
[< 1e-6]; ``detect_and_compute``: the same keypoints, and in the same
order but for swaps of scores within 1e-6 of each other (XLA and PyTorch
sum the convolutions in other orders, ~1e-7 relative) [96x128: none of
256; 100x136, shrunk to 96x128 with antialiasing first: none of 128;
384x512: 8 of 4096 rows, 4 swapped pairs, two of them zero-score
keypoints whose reliability scores nearly tie]; scores within 1e-5
[1.4e-7]; descriptors within 1e-4 [3.0e-7]; ``dense_features`` within
1e-5 [< 1e-6], at a size off the multiple of 32 too (the align-corners
resize).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artdeco_tpu.models import xfeat as JX
from artdeco_tpu.poses import feature_detector as jfd
from artdeco_tpu_torch.models import xfeat as TX
from artdeco_tpu_torch.poses import feature_detector as fd
from torch_parity import CPU, assert_same_keypoints, n, t, torch_threads  # noqa: F401


def release_sd(cfg, seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    sd = TX.XFeatModel(cfg).state_dict()
    for k, v in sd.items():
        if "running_var" in k:
            sd[k] = torch.rand(v.shape, generator=g) * 0.5 + 0.5
        elif "running_mean" in k or k.endswith(".bias"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif v.dtype.is_floating_point:
            sd[k] = torch.randn(v.shape, generator=g) / np.sqrt(v[0].numel())
    return sd


def both(cfg, seed=0):
    """(port model, JAX params, JAX model) with the same weights."""
    sd = release_sd(cfg, seed)
    model = TX.load_xfeat_state_dict(TX.XFeatModel(cfg), sd).eval()
    jcfg = JX.XFeatConfig(stride=cfg.stride, block3_stride=cfg.block3_stride, top_k=cfg.top_k)
    params = jax.tree_util.tree_map(
        jnp.asarray, JX.convert_xfeat_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg))
    return model, params, JX.XFeatModel(jcfg), jcfg


@pytest.mark.parametrize("block3_stride", [2, 1])
def test_backbone_matches_jax(block3_stride):
    cfg = TX.XFeatConfig(block3_stride=block3_stride)
    model, params, jmodel, _ = both(cfg)
    img = np.random.RandomState(1).rand(1, 3, 96, 128).astype(np.float32)
    x = TX.instance_norm_gray(t(img))
    np.testing.assert_allclose(n(x), n(JX.instance_norm_gray(jnp.asarray(img))), atol=1e-5)
    with torch.no_grad():
        outs = model(x)
    jouts = jmodel.apply({"params": params}, jnp.asarray(n(x)).transpose(0, 2, 3, 1))
    for a, b in zip(outs, jouts):
        b = np.asarray(b).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(n(a), b, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("hw,top_k", [((96, 128), 256), ((100, 136), 128), ((384, 512), 4096)])
def test_detect_and_compute_matches_jax(hw, top_k):
    cfg = TX.sparse_config(top_k=top_k)
    model, params, jmodel, jcfg = both(cfg)
    img = np.random.RandomState(1).rand(1, 3, *hw).astype(np.float32)
    jk, jf, js = map(np.asarray, JX.detect_and_compute(params, jnp.asarray(img), cfg=jcfg,
                                                       model=jmodel))
    tk, tf, ts = map(n, TX.detect_and_compute(model, t(img), cfg))
    moved = assert_same_keypoints(jk, js, tk, tol=1e-6)
    assert moved <= top_k // 400, moved
    pos = {tuple(k): i for i, k in enumerate(jk.tolist())}
    order = np.asarray([pos[tuple(k)] for k in tk.tolist()])
    np.testing.assert_allclose(ts, js[order], atol=1e-5)
    np.testing.assert_allclose(tf, jf[order], atol=1e-4)
    live = ts > 0
    assert 0 < live.sum() < top_k                 # zero-score keypoints are part of the output
    assert np.abs(tf[~live]).max() == 0.0         # and carry zeroed descriptors


@pytest.mark.parametrize("hw", [(96, 128), (100, 136)])
def test_dense_features_match_jax(hw):
    cfg = TX.dense_config()
    model, params, jmodel, _ = both(cfg, seed=1)
    img = np.random.RandomState(2).rand(1, 3, *hw).astype(np.float32)
    a = n(TX.dense_features(model, t(img)))
    b = np.asarray(JX.dense_features(params, jnp.asarray(img), model=jmodel))
    assert a.shape == b.shape == (1, hw[0] // 32 * 8, hw[1] // 32 * 8, 64)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_state_dicts_load_strictly():
    cfg = TX.sparse_config()
    sd = release_sd(cfg)
    hub = {f"net.{k}": v for k, v in sd.items()}
    hub["net.fine_matcher.0.weight"] = torch.zeros(512, 128)     # unused by the reference
    for d in (sd, hub):
        m = TX.load_xfeat_state_dict(TX.XFeatModel(cfg), d)
        for k, v in m.state_dict().items():
            assert torch.equal(v, sd[k]), k
    with pytest.raises(RuntimeError):
        TX.load_xfeat_state_dict(TX.XFeatModel(cfg), {k: v for k, v in sd.items()
                                                     if "block5" not in k})
    # JAX params -> release layout -> JAX params is the identity
    params = JX.convert_xfeat_state_dict({k: v.numpy() for k, v in sd.items()})
    back = TX.state_dict_from_flax(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)


def test_detector_from_a_checkpoint_matches_jax(tmp_path):
    """``make_detector`` and ``FeatureDetector(xfeat_checkpoint=...)`` from a
    ``.pth`` (the JAX package converts it, the port loads it), on a
    [-1, 1] image; a flax ``.npz`` is refused."""
    path = str(tmp_path / "xfeat.pth")
    torch.save({f"net.{k}": v for k, v in release_sd(TX.sparse_config()).items()}, path)
    img = np.random.RandomState(4).rand(3, 64, 96).astype(np.float32) * 2 - 1
    jk, jf, js = map(np.asarray, JX.make_detector(path, top_k=64)(img))
    tk, tf, ts = map(n, TX.make_detector(path, top_k=64, device=CPU)(img))
    assert assert_same_keypoints(jk, js, tk, tol=1e-6) == 0
    np.testing.assert_allclose(tf, jf, atol=1e-4)
    np.testing.assert_allclose(ts, js, atol=1e-5)
    jd = jfd.FeatureDetector(num_kpts=64, xfeat_checkpoint=path)(img)
    td = fd.FeatureDetector(num_kpts=64, xfeat_checkpoint=path, device=CPU)(img)
    np.testing.assert_array_equal(n(td.kpts), np.asarray(jd.kpts))
    np.testing.assert_allclose(n(td.desc), np.asarray(jd.desc), atol=1e-4)
    with pytest.raises(NotImplementedError, match="npz"):
        TX.make_detector(str(tmp_path / "xfeat.npz"), device=CPU)


def test_random_detector_runs_on_the_requested_device():
    fn = TX.make_detector(top_k=32, device=CPU, seed=3)
    kpts, feats, scores = fn(np.random.RandomState(0).rand(3, 64, 96).astype(np.float32))
    assert kpts.device.type == "cpu" and kpts.shape == (32, 2) and feats.shape == (32, 64)
    live = scores > 0
    assert torch.allclose(torch.linalg.vector_norm(feats[live], dim=-1), torch.ones(1))
    assert bool(torch.all(feats[~live] == 0))
