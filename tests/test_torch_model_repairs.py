"""Repairs in the code the model-driven slice runs, on the CPU.

* The retrieval query gets one explicit host float32 copy of the encoder
  tokens (``backend.host_tokens``): a model's ``feat`` is a device tensor,
  which ``np.asarray`` cannot read (here: bf16 and grad-tracking tensors,
  which it refuses on the CPU too).
* ``System`` and ``run_system.main`` set the float32 policy: no TF32 in
  matmuls or cuDNN convolutions.
* ``System._maybe_auto_calibrate`` with a real ``inference_mono`` (a
  device pointmap): the same decision as the JAX package from the same
  model's first frame -- a random network's pointmap gives a degenerate
  focal, so both keep the guess -- and the same fit, within 1e-3
  relative.
* The mapper image at equal SLAM and map sizes: ``MapperStage._map_image``
  gives the port's own ``to_map`` of the frame (within 1e-6), where the
  JAX package trains on the SLAM tensor in [-1, 1] (recorded here; ROADMAP
  section 3).
* ``save`` of a scene without a Gaussian (found on the card: the full
  random model's first keyframe seeded none) and the random model's depth
  prior that keeps its points in front of the camera.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.models import mast3r as JM
from artdeco_tpu.models.mast3r_infer import Mast3rRunner as JRunner
from artdeco_tpu.runtime.system import System as JSystem
from artdeco_tpu_torch.dataio.args import get_args
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.models import mast3r as TM
from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.runtime.system import MapperStage, System
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu_torch.vslam.backend import host_tokens
from torch_parity import CPU, t, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "config", "base.yaml")


def test_retrieval_gets_a_host_copy_of_device_tokens():
    feat = torch.randn(1, 12, 16)
    for dev_like in (feat.to(torch.bfloat16), feat.clone().requires_grad_(True)):
        with pytest.raises((TypeError, RuntimeError)):
            np.asarray(dev_like[0])
        host = host_tokens(dev_like)
        assert isinstance(host, np.ndarray) and host.dtype == np.float32
        np.testing.assert_array_equal(host, dev_like[0].detach().float().numpy())
    host = host_tokens(feat)
    host[0, 0] = 7.0
    assert feat[0, 0, 0] != 7.0                      # a copy, not a view


def test_system_sets_the_float32_policy(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=64), n_frames=2,
                          width=64, height=48)
    cfg = load_config(CFG)
    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=CPU)
    System(types.SimpleNamespace(retrieval_checkpoint_path=""), cfg, ds, runner, device=CPU)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _guessing(cls):
    """``cls`` (a SyntheticDataset) with its intrinsics marked as a guess
    and ``recalibrate_focal`` recorded."""

    class Guessing(cls):
        def recalibrate_focal(self, focal):
            self.focal = focal

    ds = Guessing(types.SimpleNamespace(test_hold=-1, max_size_slam=64), n_frames=2,
                  width=64, height=48)
    # both packages' datasets set the flag when they load their intrinsics
    ds.calib_is_guess = True
    return ds


def test_auto_calibration_with_the_model_matches_jax():
    jcfg = JM.tiny_config(compute_dtype=jnp.float32)
    tcfg = TM.tiny_config(compute_dtype=torch.float32)
    img = jnp.zeros((1, 3, 48, 64))
    params = JM.MASt3R(jcfg).init(jax.random.PRNGKey(3), img, img)
    match = load_config(CFG)["matching"]
    jds, tds = _guessing(JSyntheticDataset), _guessing(SyntheticDataset)
    args = types.SimpleNamespace(auto_calib=True)
    JSystem._maybe_auto_calibrate(args, jds, JRunner(jcfg, params, match))
    runner = Mast3rRunner.create(tcfg, match, state_dict=TM.state_dict_from_flax(params, tcfg),
                                 device=CPU)
    with pytest.warns(UserWarning, match="auto-calibration failed"):
        System._maybe_auto_calibrate(args, tds, runner)
    # a random network's pointmap has no focal: both fits degenerate and
    # both packages keep the guess
    assert not hasattr(tds, "focal") and not hasattr(jds, "focal")
    jX = np.asarray(JRunner(jcfg, params, match).inference_mono(
        jnp.asarray(jds.transform.to_slam(jds[0][0])))[0][0])
    tX = runner.inference_mono(t(tds.transform.to_slam(tds[0][0])))[0][0].numpy()
    np.testing.assert_allclose(tX, jX, rtol=0, atol=1e-5 * np.abs(jX).max())
    from artdeco_tpu.geometry.calibration import estimate_focal_weiszfeld as jfit
    from artdeco_tpu_torch.geometry.calibration import estimate_focal_weiszfeld as tfit

    valid = np.ones(len(jX), bool)
    assert float(tfit(t(tX), t(valid), 48, 64)) == pytest.approx(
        float(jfit(jnp.asarray(jX), jnp.asarray(valid), 48, 64)), rel=1e-3)


def test_mapper_image_at_equal_sizes():
    args = get_args(["-s", "synthetic://", "-d", "synthetic", "--max_size_slam", "64"])
    ds = SyntheticDataset(args, n_frames=2, width=64, height=48)
    jds = JSyntheticDataset(args, n_frames=2, width=64, height=48)
    assert (ds.H_map, ds.W_map) == (ds.H_slam, ds.W_slam) == (48, 64)
    stage = MapperStage(ds, device=CPU)
    img, _ = ds[1]
    m = {"frame_id": 1, "img_dev": t(ds.transform.to_slam(img))}
    got, info = stage._map_image(m, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ds.transform.to_map(img)), atol=1e-6)
    assert info["name"] == ds.image_name_list[1]
    # the JAX package trains on the SLAM tensor itself there, in [-1, 1]
    jslam = np.asarray(jds.transform.to_slam(img))
    assert jslam.min() < 0.0
    np.testing.assert_allclose(got.numpy(), (jslam + 1.0) / 2.0, atol=1e-6)


def test_save_of_an_empty_scene():
    """``save`` of a scene without a Gaussian (a random model's first
    keyframe may seed none) writes an empty PLY instead of failing in the
    coefficient reshape."""
    import tempfile

    from artdeco_tpu_torch.mapper import scene_io
    from artdeco_tpu_torch.mapper.config import MapperConfig
    from artdeco_tpu_torch.mapper.keyframe import make_device_keyframe
    from artdeco_tpu_torch.mapper.scene_model import SceneModel

    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=64), n_frames=1,
                          width=64, height=48)
    sm = SceneModel(ds.W_map, ds.H_map, ds.K_map,
                    MapperConfig(capacity=1024, cluster_capacity=256, voxel_table_size=1024,
                                 new_budget=256, keyframe_capacity=4, sh_degree=1,
                                 local_feat_dim=8, global_feat_dim=8, pyr_levels=1),
                    device=CPU)
    kf = make_device_keyframe(0, 0, ds.transform.to_map(ds[0][0]),
                              np.zeros((48, 64, 3), np.float32), np.zeros((48, 64), np.float32),
                              False, True, CPU, pyr_levels=1)
    sm.add_keyframe(kf, np.eye(4, dtype=np.float32))
    sm.add_new_gaussians(0)
    assert sm.n_active_gaussians == 0
    out = tempfile.mkdtemp()
    assert sm.save(out)["num gaussians"] == 0
    fields = scene_io.read_gaussian_ply(os.path.join(out, "point_clouds", "gs.ply"))
    assert all(len(v) == 0 for v in fields.values()) and fields["f_dc"].shape == (0, 1, 3)


def test_random_mast3r_points_lie_in_front_of_the_camera():
    """The seeded random model (no checkpoint) puts every point in front
    of the camera: its regression heads' z bias is 1."""
    runner = Mast3rRunner.create(TM.tiny_config(compute_dtype=torch.float32), device=CPU)
    for h in (runner.model.downstream_head1, runner.model.downstream_head2):
        assert float(h.dpt.head[4].bias[2]) == 1.0
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=64), n_frames=1,
                          width=64, height=48)
    X, C, _, _ = runner.inference_mono(t(ds.transform.to_slam(ds[0][0])))
    assert bool((X[..., 2] > 0).all()) and bool(torch.isfinite(C).all())
