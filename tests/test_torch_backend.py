"""The port's backend (``vslam/backend.py``, ``vslam/retrieval.py``,
``geometry/calibration.py``) against the JAX package's, on the CPU.

* Retrieval: a host copy, so the candidate lists, scores and similarity
  graph must be equal, on random features (through the kmeans codebook
  bootstrap) and on the oracle's frame-id tokens.
* ``dense_point`` on the same inputs, with thousands of duplicate targets:
  the confidence of a target is its last writer's in both (within 4e-7,
  measured 3.7e-7: the reprojection residual's float32 rounding).
* ``Backend.process`` frame by frame over a 40-frame oracle stream
  (128x96, 6 frames of motion per tracked frame, ``config/base.yaml``;
  keyframes at 0, 14 and 28, with retrieval candidates): the same
  messages, ``lc_inds`` and kept edges; ``point_map`` and ``T_CkC``
  within 1e-5 (measured 2.7e-6), ``point_conf`` equal within 1e-6 on all
  but 1 % of the pixels (measured: at most 44 of 12288 differ, where the
  two trackers' match indices differ); keyframe poses after each solve
  within 1e-4 (measured 3.8e-6).
  Relocalization: ``tests/test_torch_reloc.py``.
* ``estimate_focal_weiszfeld`` on ``tests/test_calibration.py``'s inputs,
  within 1e-3 px of the JAX package's.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.geometry.calibration import estimate_focal_weiszfeld as j_focal
from artdeco_tpu.models.oracle import OracleRunner as JOracleRunner
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu.vslam import backend as jbackend
from artdeco_tpu.vslam import retrieval as jretrieval
from artdeco_tpu.vslam.backend import Backend as JBackend
from artdeco_tpu.vslam.frontend import Frontend as JFrontend
from artdeco_tpu.vslam.keyframes import KeyframeStore as JKeyframeStore
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.geometry.calibration import estimate_focal_weiszfeld
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu_torch.vslam import backend, retrieval
from artdeco_tpu_torch.vslam.backend import Backend
from artdeco_tpu_torch.vslam.frontend import Frontend
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from test_calibration import _pointmap_from_focal
from torch_parity import CPU, n, t, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "config", "base.yaml")


def register(runner, ds):
    for i in range(len(ds)):
        img, info = ds[i]
        T = np.ones(8, np.float32)
        T[:7] = info["Twc_gt"]
        runner.register(ds.transform.to_slam(img), i, T)


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def _drive_retrieval(db, feats, adds):
    out = []
    for f, add in zip(feats, adds):
        out.append(db.update(f, add_after_query=add, k=3, min_thresh=0.0))
        if db.kf_counter:
            out.append(db._query_scores(db.head(f)).tolist())
    return out


@pytest.mark.parametrize("kind", ["random", "oracle_tokens"])
def test_retrieval_matches_jax(kind):
    cfg = load_config(CFG)
    rng = np.random.RandomState(3)
    if kind == "random":
        # 16 centroids: the kmeans bootstrap runs after the 4th image
        feats = [rng.randn(20, 8).astype(np.float32) for _ in range(12)]
        kw = dict(num_centroids=16)
    else:
        feats = []
        for fid in range(30):
            f = np.zeros((4, 4), np.float32)
            f[0, 0] = fid
            feats.append(f)
        kw = {}
    adds = [i % 5 != 3 for i in range(len(feats))]
    dbs = (retrieval.RetrievalDatabase(cfg, **kw), jretrieval.RetrievalDatabase(cfg, **kw))
    got, want = (_drive_retrieval(db, feats, adds) for db in dbs)
    assert got == want
    db, jdb = dbs
    assert any(r for r in got[::2]), "no candidates at all"
    np.testing.assert_array_equal(db.centroids, jdb.centroids)
    assert db.image_norms == jdb.image_norms
    assert {k: v for k, v in db.sim_graph.sim.items()} == dict(jdb.sim_graph.sim)
    assert sorted(db.ivf) == sorted(jdb.ivf)
    for c in db.ivf:
        assert db.ivf[c][0] == jdb.ivf[c][0]
        np.testing.assert_array_equal(np.stack(db.ivf[c][1]), np.stack(jdb.ivf[c][1]))


# ---------------------------------------------------------------------------
# dense points
# ---------------------------------------------------------------------------

def test_dense_point_duplicate_targets_match_jax():
    """Every second source pixel hits one of a few hundred targets: the
    points there are equal, the confidences (from each source pixel's own
    reprojection) are not, and both packages keep the last writer's."""
    h, w = 24, 32
    rng = np.random.RandomState(5)
    K = np.asarray([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    X = np.concatenate([rng.randn(h * w, 2) * 0.3, rng.uniform(1, 3, (h * w, 1))],
                       -1).astype(np.float32)
    idx = rng.randint(0, h * w, h * w)
    idx[::2] = rng.randint(0, 300, (h * w + 1) // 2)
    Twk = np.asarray([0.05, -0.02, 0.01, 0.01, 0.02, -0.01, 0.9997, 1.02], np.float32)
    Twk[3:7] /= np.linalg.norm(Twk[3:7])
    Twl = np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
    pj, cj = jbackend._dense_point_jit(jnp.asarray(idx), jnp.asarray(X), jnp.asarray(Twk),
                                       jnp.asarray(Twl), jnp.asarray(K), h, w)
    pt, ct = backend.dense_point(t(idx), t(X), t(Twk), t(Twl), t(K), h, w)
    assert len(idx) - len(np.unique(idx)) > 300
    np.testing.assert_allclose(n(pt), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(n(ct), np.asarray(cj), atol=4e-7)
    assert (n(ct) > 0).sum() == len(np.unique(idx))


# ---------------------------------------------------------------------------
# Backend.process over an oracle stream
# ---------------------------------------------------------------------------

STRIDE, N_STREAM, W, H = 6, 40, 128, 96


def strided(base):
    """The synthetic stream with STRIDE times its motion per frame (poses
    only: the oracle finds frames by their images and serves geometry
    from the registered poses, as in ``tests/test_reloc.py``)."""
    class Strided(base):
        def __init__(self, args):
            super().__init__(args, n_frames=N_STREAM, width=W, height=H)
            self.Twc_gt = self.Twc_gt.copy()
            self.Twc_gt[:, 0] *= STRIDE
    return Strided


def _stream(fe_cls, bk_cls, ks_cls, runner_cls, ds, cfg, rdb, **dev):
    runner = runner_cls((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], **dev)
    register(runner, ds)
    args = types.SimpleNamespace()
    ks = ks_cls(ds.H_slam, ds.W_slam, K_slam=ds.K_slam, **dev)
    fe = fe_cls(args, cfg, ds, ks, runner, **dev)
    bk = bk_cls(args, cfg, ds, ks, runner, retrieval=rdb, **dev)
    out = []
    for i in range(len(ds)):
        msg = fe.process_frame(*ds[i])
        mm = bk.process(msg) if msg is not None else None
        n_kf = len(ks)
        if mm is not None:
            # copies now: a JAX array made from a host row may share its
            # memory on the CPU, and the next solve rewrites that row
            mm = {k: np.array(n(v)) if hasattr(v, "shape") else v for k, v in mm.items()}
        out.append(dict(style=None if msg is None else msg["keyframe_style"], mm=mm,
                        T_WC=ks.T_WC[:n_kf].copy(),
                        edges=(bk.factor_graph.e_ii[:bk.factor_graph.n_directed].copy(),
                               bk.factor_graph.e_jj[:bk.factor_graph.n_directed].copy())))
    return out, ks, bk


@pytest.fixture(scope="module")
def backend_streams():
    args = types.SimpleNamespace(test_hold=-1, max_size_slam=W)
    jcfg, cfg = jload_config(CFG), load_config(CFG)
    jout, jks, _ = _stream(JFrontend, JBackend, JKeyframeStore, JOracleRunner,
                           strided(JSyntheticDataset)(types.SimpleNamespace(**vars(args))),
                           jcfg, jretrieval.RetrievalDatabase(jcfg))
    tout, tks, tbk = _stream(Frontend, Backend, KeyframeStore, OracleRunner,
                             strided(SyntheticDataset)(args), cfg,
                             retrieval.RetrievalDatabase(cfg), device=CPU)
    return jout, jks, tout, tks, tbk


def test_backend_process_matches_jax(backend_streams):
    jout, jks, tout, tks, tbk = backend_streams
    n_kf = len(tks)
    assert n_kf == len(jks) >= 3
    np.testing.assert_array_equal(tks.dataset_idx[:n_kf], jks.dataset_idx[:n_kf])
    assert tbk.factor_graph.n_directed >= 4
    lc_seen = set()
    for j, p in zip(jout, tout):
        assert p["style"] == j["style"]
        np.testing.assert_allclose(p["T_WC"], j["T_WC"], atol=1e-4)
        for a, b in zip(p["edges"], j["edges"]):
            np.testing.assert_array_equal(a, b)
        a, b = p["mm"], j["mm"]
        assert (a is None) == (b is None)
        if a is None:
            continue
        for key in ("frame_id", "is_slam_keyframe", "last_keyframe_index", "loop_keyframe_index"):
            assert a[key] == b[key], key
        lc_seen |= a["loop_keyframe_index"]
        np.testing.assert_allclose(a["T_WC"], b["T_WC"], atol=1e-4)
        np.testing.assert_allclose(a["point_map"], b["point_map"], atol=1e-5)
        conf_bad = np.abs(a["point_conf"] - b["point_conf"]) > 1e-6
        assert conf_bad.mean() <= 0.01, conf_bad.sum()
        assert (a["T_CkC"] is None) == (b["T_CkC"] is None)
        if a["T_CkC"] is not None:
            np.testing.assert_allclose(a["T_CkC"], b["T_CkC"], atol=1e-5)
    assert len(lc_seen) >= 2


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["exact", "outliers", "validity_gate"])
def test_focal_estimate_matches_jax(case):
    """``tests/test_calibration.py``'s three inputs through both."""
    if case == "exact":
        h, w, rng = 96, 128, np.random.RandomState(0)
        X, valid, f_true = _pointmap_from_focal(h, w, 110.0, rng), np.ones(h * w, bool), 110.0
    elif case == "outliers":
        h, w, rng = 96, 128, np.random.RandomState(1)
        X, f_true = _pointmap_from_focal(h, w, 140.0, rng), 140.0
        bad = rng.rand(h * w) < 0.3
        X[bad] = rng.randn(bad.sum(), 3) * 3 + np.asarray([0, 0, 2.5])
        valid = np.ones(h * w, bool)
    else:
        h, w, rng = 64, 96, np.random.RandomState(2)
        X, f_true = _pointmap_from_focal(h, w, 80.0, rng), 80.0
        valid = np.ones(h * w, bool)
        kill = rng.rand(h * w) < 0.2
        X[kill, 2] = -1.0
        valid[kill] = False
    fj = float(j_focal(jnp.asarray(X), jnp.asarray(valid), h, w))
    ft = float(estimate_focal_weiszfeld(t(X), t(valid), h, w))
    assert abs(ft - fj) < 1e-3, (ft, fj)
    assert abs(ft - f_true) / f_true < 0.05
