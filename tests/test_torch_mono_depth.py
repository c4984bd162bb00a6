"""The port's k-NN distances (``ops/knn.py``) and mono-depth providers
(``mapper/mono_depth.py``) against the JAX package's, on the CPU.

Tolerances (the measured gaps in brackets): Morton codes and sort order
equal; ``knn_mean_sq_dist`` within 1e-6 relative [< 1e-7: the same three
values are averaged in the same order]; the numpy providers equal
(the same host code); ``DenseExtractor`` with XFeat's dense variant as
its ``model_fn`` within 1e-5 [< 1e-6].
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artdeco_tpu.mapper import mono_depth as JM
from artdeco_tpu.models import xfeat as JX
from artdeco_tpu.ops import knn as jknn
from artdeco_tpu_torch.mapper import mono_depth as TM
from artdeco_tpu_torch.models import xfeat as TX
from artdeco_tpu_torch.ops import knn
from test_torch_xfeat import release_sd
from torch_parity import CPU, n, t, torch_threads  # noqa: F401


@pytest.mark.parametrize("k,window", [(3, 16), (5, 8)])
def test_knn_matches_jax(k, window):
    rng = np.random.RandomState(0)
    xyz = (rng.randn(4000, 3) * [2.0, 1.0, 0.5]).astype(np.float32)
    xyz[100:110] = xyz[0]                     # duplicate points: zero distances
    np.testing.assert_array_equal(n(knn.morton_codes(t(xyz))),
                                  np.asarray(jknn.morton_codes(jnp.asarray(xyz))).astype(np.int64))
    a = n(knn.knn_mean_sq_dist(t(xyz), k=k, window=window))
    b = np.asarray(jknn.knn_mean_sq_dist(jnp.asarray(xyz), k=k, window=window))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    assert a[100] == 0.0
    # an array input goes to the device asked for
    c = knn.knn_mean_sq_dist(xyz, k=k, window=window, device=CPU)
    assert c.device.type == "cpu" and torch.equal(c, t(a))


def test_mono_depth_providers_match_jax():
    rng = np.random.RandomState(1)
    pm = np.concatenate([rng.randn(40, 50, 2), rng.uniform(0.5, 3, (40, 50, 1))], -1)
    pm[5:8, 5:8, 2] = 0.0
    pm = pm.astype(np.float32)
    np.testing.assert_array_equal(TM.idepth_from_pointmap(pm), JM.idepth_from_pointmap(pm))
    for a, b in zip(TM.MonoDepthEstimator()(None, point_map=pm),
                    JM.MonoDepthEstimator()(None, point_map=pm)):
        np.testing.assert_array_equal(a, b)
    fn = lambda img: img[0] * 2.0                               # noqa: E731
    img = rng.rand(3, 40, 50).astype(np.float32)
    for a, b in zip(TM.MonoDepthEstimator(fn)(img), JM.MonoDepthEstimator(fn)(img)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TM.MonoDepthEstimator()(img)
    for dim in (4, 8):
        np.testing.assert_array_equal(TM.DenseExtractor(dim=dim)(img),
                                      JM.DenseExtractor(dim=dim)(img))


def test_dense_extractor_with_xfeat_matches_jax(tmp_path):
    path = str(tmp_path / "xfeat.pth")
    sd = release_sd(TX.dense_config(), seed=5)
    torch.save(sd, path)
    params = jax.tree_util.tree_map(
        jnp.asarray, JX.convert_xfeat_state_dict({k: v.numpy() for k, v in sd.items()}))
    jmodel = JX.XFeatModel(JX.dense_config())
    img = np.random.RandomState(6).rand(3, 64, 96).astype(np.float32)
    b = JM.DenseExtractor(lambda x: JX.dense_features(params, jnp.asarray(x)[None],
                                                      model=jmodel)[0])(img)
    a = TM.DenseExtractor(TX.make_dense_fn(path, device=CPU))(img)
    assert a.shape == b.shape == (16, 24, 64) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=1e-5)
