"""The port's System through loop closures, and a backend resumed from the
JAX package's state, against the JAX package on the CPU.

* ``System`` on ``tests/test_system.py``'s settings with six times the
  motion per frame (poses only, as ``tests/test_reloc.py`` moves them),
  40 frames: keyframes at frames 0, 14 and 28, each after the first
  running ``add_factors``, a GN solve and the scene's rigid transform.
  The same keyframe frames, 0 lost, keyframe poses and the frame
  trajectory within 1e-4, ATE within 1e-4 of JAX's, one rigid transform
  of the scene per SLAM keyframe after frame 0, and the mapper's keyframe
  poses within 1e-3 of JAX's (measured 2.6e-4: the rigid transform sets
  them from the SLAM poses, then the mapper's Adam moves them by 1e-4 a
  step, in either direction where their gradients are near 0); the
  Gaussian count within 2 %, the mapper being chaotic.
* A backend resumed from a mid-stream JAX backend (``vslam/state_io``:
  keyframes, tracker, edge store, retrieval database): with the keyframe
  poses disturbed alike on both sides, one ``solve_GN_calib`` gives the
  same poses within 1e-4, and the next retrieval query the same
  candidates.
"""

import types

import numpy as np
import pytest

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.mapper import keyframe as JKF
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.models.oracle import OracleRunner as JOracleRunner
from artdeco_tpu.runtime.system import System as JSystem
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu.vslam import retrieval as jretrieval
from artdeco_tpu.vslam.backend import Backend as JBackend
from artdeco_tpu.vslam.frontend import Frontend as JFrontend
from artdeco_tpu.vslam.keyframes import KeyframeStore as JKeyframeStore
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper import keyframe as KF
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.state_io import scene_state_from_numpy
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.runtime.system import System
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu_torch.vslam import retrieval
from artdeco_tpu_torch.vslam.backend import Backend
from artdeco_tpu_torch.vslam.frontend import Frontend
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from artdeco_tpu_torch.vslam.state_io import (backend_state_from_numpy, frontend_state_from_numpy,
                                              load_backend_state, load_frontend_state)
from test_system import _args
from test_torch_backend import CFG, register, strided
from test_torch_system import SIZES, _config
from torch_parity import (CPU, JaxKeyChain, jax_backend_state, jax_frontend_state,  # noqa: F401
                          jax_scene_state, n, torch_threads)

STRIDE, N_FRAMES = 6, 40


def _moving(base):
    class Moving(base):
        def __init__(self, args):
            super().__init__(args, n_frames=N_FRAMES, width=160, height=120)
            self.Twc_gt = self.Twc_gt.copy()
            self.Twc_gt[:, 0] *= STRIDE
    return Moving


def test_system_loop_closures_match_jax():
    args = _args()
    jds = _moving(JSyntheticDataset)(args)
    jcfg = _config(jload_config)
    jr = JOracleRunner((jds.H_slam, jds.W_slam), jds.K_slam, jcfg["matching"])
    register(jr, jds)
    jsys = JSystem(args, jcfg, jds, jr, mapper_cfg=JMapperConfig(**SIZES))
    args = _args()
    ds = _moving(SyntheticDataset)(args)
    cfg = _config(load_config)
    r = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=CPU)
    register(r, ds)
    tsys = System(args, cfg, ds, r, mapper_cfg=MapperConfig(**SIZES), device=CPU,
                  noise=JaxKeyChain(0))
    tsys.scene_model.load_state(scene_state_from_numpy(jax_scene_state(jsys.scene_model), CPU))
    jsys.run(progress=False)
    tsys.run(progress=False)

    assert tsys.frontend.lost_number == jsys.frontend.lost_number == 0
    n_kf = len(tsys.keyframes)
    assert n_kf == len(jsys.keyframes) >= 3
    np.testing.assert_array_equal(tsys.keyframes.dataset_idx[:n_kf],
                                  jsys.keyframes.dataset_idx[:n_kf])
    np.testing.assert_allclose(tsys.keyframes.T_WC[:n_kf], jsys.keyframes.T_WC[:n_kf],
                               atol=1e-4)
    est, jest = tsys.frontend.estimated_trajectory(), jsys.frontend.estimated_trajectory()
    assert est.shape == jest.shape
    np.testing.assert_allclose(est, jest, atol=1e-4)
    fg = tsys.backend.factor_graph
    assert len(fg.solves) == n_kf - 1
    np.testing.assert_array_equal(fg.e_ii, jsys.backend.factor_graph.e_ii)
    np.testing.assert_array_equal(fg.e_jj, jsys.backend.factor_graph.e_jj)
    assert tsys.mapper.rigid_transforms == n_kf - 1
    m = tsys.mapper_index
    assert m == jsys.mapper_index
    np.testing.assert_allclose(n(KF.get_all_Rt(tsys.scene_model.pool))[:m],
                               np.asarray(JKF.get_all_Rt(jsys.scene_model.pool))[:m], atol=1e-3)
    gs, jgs = tsys.scene_model.n_active_gaussians, int(jsys.scene_model.n_active_gaussians)
    assert abs(gs - jgs) <= 0.02 * jgs and gs > 100
    from artdeco_tpu.eval.trajectory import evaluate_trajectory as jeval
    from artdeco_tpu_torch.eval.trajectory import evaluate_trajectory

    ate = evaluate_trajectory("", "unused.json", est, np.asarray(tsys.frontend.frames_Twc_gt),
                              max_dt=0.05)["APE"]["rmse"]
    jate = jeval("", "unused.json", jest, np.asarray(jsys.frontend.frames_Twc_gt),
                 max_dt=0.05)["APE"]["rmse"]
    assert abs(ate - jate) <= 1e-4 and ate < 0.03, (ate, jate)


@pytest.mark.parametrize("stop_at", [32])
def test_backend_resumes_from_jax_state(stop_at):
    args = types.SimpleNamespace(test_hold=-1, max_size_slam=128)
    jds = strided(JSyntheticDataset)(types.SimpleNamespace(**vars(args)))
    jcfg, cfg = jload_config(CFG), load_config(CFG)
    jr = JOracleRunner((jds.H_slam, jds.W_slam), jds.K_slam, jcfg["matching"])
    register(jr, jds)
    jks = JKeyframeStore(jds.H_slam, jds.W_slam, K_slam=jds.K_slam)
    jfe = JFrontend(types.SimpleNamespace(), jcfg, jds, jks, jr)
    jbk = JBackend(types.SimpleNamespace(), jcfg, jds, jks, jr,
                   retrieval=jretrieval.RetrievalDatabase(jcfg))
    for i in range(stop_at):
        msg = jfe.process_frame(*jds[i])
        if msg is not None:
            jbk.process(msg)
    assert len(jks) >= 3 and jbk.factor_graph.n_directed >= 4

    ds = strided(SyntheticDataset)(args)
    r = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=CPU)
    register(r, ds)
    ks = KeyframeStore(ds.H_slam, ds.W_slam, K_slam=ds.K_slam, device=CPU)
    fe = Frontend(types.SimpleNamespace(), cfg, ds, ks, r, device=CPU)
    bk = Backend(types.SimpleNamespace(), cfg, ds, ks, r,
                 retrieval=retrieval.RetrievalDatabase(cfg), device=CPU)
    load_frontend_state(fe, frontend_state_from_numpy(jax_frontend_state(jfe), CPU))
    load_backend_state(bk, backend_state_from_numpy(jax_backend_state(jbk), CPU))
    assert bk.factor_graph.n_directed == jbk.factor_graph.n_directed
    for k in ("idx", "vm", "q"):
        np.testing.assert_array_equal(
            n(bk.factor_graph._dev_edges[k][:bk.factor_graph.n_directed]),
            np.asarray(jbk.factor_graph._dev_edges[k])[:bk.factor_graph.n_directed])

    # disturb the poses alike, then one solve on each side
    n_kf = len(ks)
    rng = np.random.RandomState(0)
    d = np.zeros((n_kf, 8), np.float32)
    d[1:, :3] = 0.02 * rng.randn(n_kf - 1, 3)
    for store in (ks, jks):
        store.T_WC[:n_kf] += d
    before = ks.T_WC[:n_kf].copy()
    bk.factor_graph.solve_GN_calib()
    jbk.factor_graph.solve_GN_calib()
    assert np.abs(ks.T_WC[:n_kf] - before).max() > 1e-3      # the solve moved them
    np.testing.assert_allclose(ks.T_WC[:n_kf], jks.T_WC[:n_kf], atol=1e-4)
    feat = np.zeros((4, 4), np.float32)
    feat[0, 0] = stop_at
    rc = cfg["retrieval"]
    assert (bk.retrieval.update(feat, False, rc["k"], rc["min_thresh"])
            == jbk.retrieval.update(feat, False, rc["k"], rc["min_thresh"]))
