"""The port's LPIPS (``artdeco_tpu_torch/eval/lpips.py``) against the JAX
package's, on the CPU, and LPIPS in the mapper's output.

Both weight routes feed both packages the same weights: the seeded random
AlexNet (the same ``np.random.RandomState`` draws, bitwise equal) and a
torch-layout state dict through each package's ``convert_lpips_torch``.
On ``tests/test_lpips.py``'s inputs the scores agree within 1e-6 relative
(plus 1e-7 absolute) [measured 1.3e-7 relative].  ``SceneModel.evaluate(
with_lpips=True)`` reports the mean LPIPS of its test renders, which the
JAX metric gives for the same render and image within 1e-6; ``save_scene``
reports it by default, as the JAX package's does.
"""

import numpy as np
import pytest
import torch

from artdeco_tpu.eval import lpips as jlp
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.eval import lpips as tlp
from artdeco_tpu_torch.mapper import scene_io
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.keyframe import make_device_keyframe
from artdeco_tpu_torch.mapper.scene_model import SceneModel
from artdeco_tpu_torch.runtime.system import plane_pointmap
from test_lpips import _synth_torch_sd
from torch_parity import CPU, t, torch_threads  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7


def _images():
    """tests/test_lpips.py's three images: a, a slightly noisy copy, another."""
    rng = np.random.RandomState(0)
    a = rng.rand(3, 48, 64).astype(np.float32)
    small = np.clip(a + 0.05 * rng.randn(3, 48, 64), 0, 1).astype(np.float32)
    big = rng.rand(3, 48, 64).astype(np.float32)
    return a, small, big


def _params(route):
    if route == "random":
        return jlp.random_lpips_params(0), tlp.random_lpips_params(0)
    sd = _synth_torch_sd(np.random.RandomState(1))
    sd["lin0.model.1.weight"] -= 0.5          # negative head entries are clamped
    return jlp.convert_lpips_torch(sd), tlp.convert_lpips_torch(
        {k: torch.from_numpy(v) for k, v in sd.items()})


@pytest.mark.parametrize("route", ["random", "converted"])
def test_lpips_matches_jax(route):
    jp, tp = _params(route)
    for a, b in zip(jp, tp):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
    jm, tm = jlp.Lpips(jp), tlp.Lpips(tp)
    a, small, big = _images()
    scores = []
    for x, y in ((a, a), (a, small), (a, big), (small, big)):
        j = float(jm(x, y))
        s = float(tm(t(x), t(y)))
        assert s == pytest.approx(j, rel=RTOL, abs=ATOL), (j, s)
        scores.append(s)
    assert scores[0] == pytest.approx(0.0, abs=1e-6)
    assert 0 < scores[1] < scores[2]


def test_default_lpips_reads_the_npz(tmp_path, monkeypatch):
    """``$ARTDECO_LPIPS_NPZ`` selects converted weights; without it the
    seeded fallback."""
    sd = _synth_torch_sd(np.random.RandomState(2))
    path = tmp_path / "lpips.npz"
    np.savez(path, **sd)
    monkeypatch.setattr(tlp, "_default", None)
    monkeypatch.setenv("ARTDECO_LPIPS_NPZ", str(path))
    m = tlp.get_default_lpips()
    assert not m.is_fallback and tlp.get_default_lpips() is m
    np.testing.assert_array_equal(m.params.conv_w[2], sd["features.6.weight"])
    monkeypatch.setattr(tlp, "_default", None)
    monkeypatch.delenv("ARTDECO_LPIPS_NPZ")
    assert tlp.get_default_lpips().is_fallback


def _scene():
    """A port SceneModel with three plane keyframes, the middle one held out."""
    ds = SyntheticDataset(type("A", (), {"test_hold": -1, "max_size_slam": 64})(),
                          n_frames=3, width=64, height=48)
    cfg = MapperConfig(capacity=2048, cluster_capacity=512, voxel_table_size=4096,
                       new_budget=512, keyframe_capacity=8, sh_degree=1, local_feat_dim=8,
                       global_feat_dim=8, pyr_levels=1, gs_add_ratio=1.0,
                       init_proba_scaler=4.0)
    sm = SceneModel(ds.W_map, ds.H_map, ds.K_map, cfg, device=CPU, seed=0)
    K = np.asarray(ds.K_slam, np.float32)
    for i in range(3):
        T = np.concatenate([np.asarray(ds.Twc_gt[i], np.float32), [1.0]]).astype(np.float32)
        img = ds.transform.to_map(ds[i][0])
        kf = make_device_keyframe(i, i, img, plane_pointmap(T, K, ds.H_slam, ds.W_slam),
                                  np.full((ds.H_slam, ds.W_slam), 5.0, np.float32),
                                  is_test=i == 1, is_slam_keyframe=i == 0, device=CPU,
                                  pyr_levels=1)
        Rt = np.eye(4, dtype=np.float32)
        Rt[0, 3] = -T[0]
        sm.add_keyframe(kf, Rt)
        sm.add_new_gaussians(i)
    sm.optimization_loop(3, True)
    return sm


def test_evaluate_and_save_report_lpips(tmp_path):
    sm = _scene()
    plain = sm.evaluate()
    assert "LPIPS" not in plain and plain["n_test_frames"] == 1
    ev = sm.evaluate(with_lpips=True)
    kf = sm.keyframes[1]
    render = sm.render_from_id(1, pyr_lvl=0)["render"]
    want = float(jlp.get_default_lpips()(render.detach().numpy(), kf.image_pyr[0].numpy()))
    assert ev["LPIPS"] == pytest.approx(want, rel=RTOL, abs=ATOL)
    assert 0 < ev["LPIPS"] and np.isfinite(ev["LPIPS"])
    for k in ("PSNR", "SSIM", "Render", "GS"):
        assert ev[k] == plain[k]
    saved = scene_io.save_scene(sm, "")
    assert saved["LPIPS"] == pytest.approx(ev["LPIPS"], rel=1e-6)
    assert "LPIPS" not in scene_io.save_scene(sm, "", with_lpips=False)
    assert sm.save(str(tmp_path / "scene"))["LPIPS"] == pytest.approx(ev["LPIPS"], rel=1e-6)
