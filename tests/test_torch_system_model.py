"""The model-driven slice as a whole: the port's ``System`` with MASt3R
(and Pi3 accurate loop closure) against the JAX package's, on the CPU, and
the entry point without ``--oracle``.

Both systems run the tiny float32 MASt3R built from the same
``convert_mast3r.synth_state_dict`` and the tiny float32 Pi3 from the same
``synth_pi3_state_dict`` over a 6-frame synthetic stream at
``tests/test_system.py``'s settings (SLAM 128x96, map 80x60, the small
matching window).  Random weights carry no geometry: their pointmaps are
nearly constant, no match is valid, so every frame after the first is
lost, and each lost frame runs relocalization -- a mono inference, a
retrieval query that Pi3 verifies (the accurate matcher's whole path:
resize, a 24-frame joint Pi3 forward, ``match_pi3``) and, for candidates
it keeps, a symmetric match through the real decode.

The JAX package's ``Backend.relocalization`` queries retrieval before it
appends the lost frame, so its accurate matcher asks the keyframe store for
an image it does not hold yet (``KeyError``; ROADMAP section 3).  The port
appends first; the JAX system here runs with its relocalization reordered
the same way (``_reloc_append_first``, a test-local patch).  Held equal:
the lost count, the keyframes, the Pi3 calls with their candidate lists,
the keyframe pose (within 1e-6) and the mapper frames; the Gaussian count
within 2 % (the port's mapper starts from the JAX mapper's state and noise,
as in ``test_torch_system.py``);
the Pi3 match fractions within 0.01 [3e-3: Pi3's random points have no
geometry either, and ``iter_proj`` ends unconverged pixels where rounding
puts them].  LPIPS against the JAX package's in a full run is held by
``test_torch_system.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.models import mast3r as JM
from artdeco_tpu.models import pi3 as JP
from artdeco_tpu.models.convert_mast3r import convert_state_dict, synth_state_dict
from artdeco_tpu.models.convert_pi3 import convert_pi3_state_dict, synth_pi3_state_dict
from artdeco_tpu.models.mast3r_infer import Mast3rRunner as JRunner
from artdeco_tpu.runtime.system import System as JSystem
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu.vslam import backend as JB
from artdeco_tpu.vslam.accurate_lc import make_pi3_accurate_matcher as jmake
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.models import mast3r as TM
from artdeco_tpu_torch.models import pi3 as TP
from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner
from artdeco_tpu_torch.runtime.system import System
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu_torch.vslam.accurate_lc import make_pi3_accurate_matcher
from artdeco_tpu_torch.mapper.state_io import scene_state_from_numpy
from test_system import _args
from torch_parity import CPU, JaxKeyChain, jax_scene_state, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "config", "base.yaml")
N_FRAMES = 6
SIZES = dict(capacity=4096, cluster_capacity=1024, voxel_table_size=4096, new_budget=1024,
             keyframe_capacity=64, sh_degree=1, local_feat_dim=8, global_feat_dim=8,
             pyr_levels=1, gs_add_ratio=1.0, init_proba_scaler=4.0)
PI3_HW = (112, 140)


def _config(load):
    cfg = load(CFG)
    cfg["matching"].update(radius=1, dilation_max=1, dist_thresh=0.05)
    return cfg


def _reloc_append_first(self, frame, feat, pos):
    """The JAX ``Backend.relocalization`` with the lost frame appended
    before the retrieval query, as the port's does."""
    rc = self.config["retrieval"]
    idx = self.keyframes.append(frame)
    inds = self.retrieval.update(np.asarray(feat[0]), add_after_query=False, k=rc["k"],
                                 min_thresh=rc["min_thresh"])
    if not inds:
        self.keyframes.pop_last()
        return False, set()
    self.keyframes.put_embedding(idx, feat, pos)
    ok = self.factor_graph.add_factors(list(inds), [idx] * len(inds),
                                       self.config["reloc"]["min_match_frac"],
                                       is_reloc=self.config["reloc"]["strict"])
    if not ok:
        self.keyframes.pop_last()
        return False, set()
    self.retrieval.update(np.asarray(feat[0]), add_after_query=True, k=rc["k"],
                          min_thresh=rc["min_thresh"])
    self.keyframes.T_WC[idx] = self.keyframes.T_WC[inds[0]].copy()
    self.factor_graph.solve_GN_calib()
    return True, set(inds)


def _count(db, log):
    inner = db.accurate_matcher

    def matcher(cand, query):
        fracs = inner(cand, query)
        log.append((list(cand), query, list(np.round(fracs, 3))))
        return fracs

    db.accurate_matcher = matcher


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    mcfg_j = JM.tiny_config(compute_dtype=jnp.float32)
    pcfg_j = JP.tiny_pi3_config(compute_dtype=jnp.float32)
    sd, psd = synth_state_dict(mcfg_j), synth_pi3_state_dict(pcfg_j, seed=1)
    args = _args(accurate_loop_closure=False)

    # the JAX package
    ds = JSyntheticDataset(args, n_frames=N_FRAMES, width=160, height=120)
    cfg = _config(jload_config)
    params, pparams = convert_state_dict(sd, mcfg_j), convert_pi3_state_dict(psd, pcfg_j)
    jsys = JSystem(args, cfg, ds, JRunner(mcfg_j, params, cfg["matching"]),
                   mapper_cfg=JMapperConfig(**SIZES))
    jsys.backend.retrieval.accurate_matcher = jmake(
        jax.jit(lambda x: JP.Pi3(pcfg_j).apply(pparams, x)), jsys.keyframes, cfg["matching"],
        resize_hw=PI3_HW)
    jlog = []
    _count(jsys.backend.retrieval, jlog)
    mapper_start = jax_scene_state(jsys.scene_model)
    orig = JB.Backend.relocalization
    JB.Backend.relocalization = _reloc_append_first
    try:
        jsys.run(progress=False, use_native_loader=False, overlap=False)
    finally:
        JB.Backend.relocalization = orig

    # the port
    ds = SyntheticDataset(args, n_frames=N_FRAMES, width=160, height=120)
    cfg = _config(load_config)
    runner = Mast3rRunner.create(TM.tiny_config(compute_dtype=torch.float32), cfg["matching"],
                                 state_dict=sd, device=CPU)
    tsys = System(args, cfg, ds, runner, mapper_cfg=MapperConfig(**SIZES), device=CPU,
                  noise=JaxKeyChain(0))
    tsys.scene_model.load_state(scene_state_from_numpy(mapper_start, CPU))
    pi3 = TP.load_pi3_state_dict(TP.Pi3(TP.tiny_pi3_config(compute_dtype=torch.float32)), psd)
    tsys.backend.retrieval.accurate_matcher = make_pi3_accurate_matcher(
        torch.no_grad()(pi3), tsys.keyframes, cfg["matching"], resize_hw=PI3_HW)
    tlog = []
    _count(tsys.backend.retrieval, tlog)
    tsys.run(progress=False, overlap=False)
    jout, tout = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "port"))
    return jsys, tsys, jsys.save(jout), tsys.save(tout), jlog, tlog


def test_model_system_matches_jax(ran):
    jsys, tsys, jmeta, tmeta, jlog, tlog = ran
    assert tsys.n_frames == jsys.n_frames == N_FRAMES
    assert tsys.frontend.lost_number == jsys.frontend.lost_number
    n_kf = len(tsys.keyframes)
    assert n_kf == len(jsys.keyframes) >= 1
    np.testing.assert_array_equal(tsys.keyframes.dataset_idx[:n_kf],
                                  jsys.keyframes.dataset_idx[:n_kf])
    np.testing.assert_allclose(tsys.keyframes.T_WC[:n_kf], jsys.keyframes.T_WC[:n_kf],
                               atol=1e-6)
    assert [c[:2] for c in tlog] == [c[:2] for c in jlog] and len(tlog) >= 1
    for (_, _, tf), (_, _, jf) in zip(tlog, jlog):
        np.testing.assert_allclose(tf, jf, atol=0.01)
    assert tsys.mapper_index == jsys.mapper_index >= 1
    assert abs(tmeta["n_gaussians"] - jmeta["n_gaussians"]) <= 0.02 * jmeta["n_gaussians"]
    assert tmeta["n_gaussians"] > 0
    tm, jm = tmeta["metrics"], jmeta["metrics"]
    assert tm["n_test_frames"] == jm["n_test_frames"]
    if tm["n_test_frames"]:
        assert abs(tm["PSNR"] - jm["PSNR"]) < 0.1
        assert abs(tm["SSIM"] - jm["SSIM"]) < 2e-3
        assert abs(tm["LPIPS"] - jm["LPIPS"]) < 2e-3 and np.isfinite(tm["LPIPS"])


def test_entry_point_runs_the_model_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``run_system.main`` without ``--oracle``: the tiny float32 MASt3R and
    tiny Pi3 accurate loop closure on random weights (both warnings
    printed), through ``save`` with LPIPS, under the float32 policy."""
    from artdeco_tpu_torch import run_system

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)

    out = tmp_path / "run"
    meta = run_system.main([
        "-s", "synthetic://", "-d", "synthetic", "--model_size", "tiny",
        "--accurate_loop_closure", "--device", "cpu", "--max_size_slam", "64",
        "--downsampling", "4", "--test_hold", "4", "--num_key_iterations", "2",
        "--sh_degree", "1", "--local_feat_dim", "8", "--global_feat_dim", "8",
        "--pyr_levels", "1", "--retrieval_checkpoint_path", "", "--checkpoint_path", "",
        "-m", str(out)])
    printed = capsys.readouterr().out
    assert "WARNING: no checkpoint" in printed and "WARNING: no Pi3 checkpoint" in printed
    assert meta["n_frames"] == 30 and (out / "run_metadata.json").is_file()
    assert meta["metrics"]["n_test_frames"] >= 1
    assert np.isfinite(meta["metrics"]["LPIPS"]) and meta["metrics"]["LPIPS"] > 0
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_entry_point_needs_a_card_unless_told(monkeypatch):
    """Without ``--device`` and with no CUDA device the entry point raises
    (no CPU fallback), before it builds anything."""
    from artdeco_tpu_torch import run_system

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        run_system.main(["-s", "synthetic://", "-d", "synthetic", "--model_size", "tiny"])
