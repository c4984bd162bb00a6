"""Shared helpers of the JAX <-> PyTorch parity tests (tests/test_torch_*.py).

Both packages run on the CPU; data crosses between them as numpy arrays.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def torch_threads():
    """Few torch threads: the suite runs in several worker processes, and
    a fixed count keeps CPU reductions in one order run to run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def t(a, dtype=None):
    """numpy / jax array -> CPU tensor (a copy)."""
    return torch.tensor(np.array(a), dtype=dtype)


def n(x):
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_scene_state(sm) -> dict:
    """The leaves of a JAX SceneModel as the nested numpy dict that
    ``artdeco_tpu_torch.mapper.state_io.scene_state_from_numpy`` takes."""
    a = np.asarray

    def ad(s):
        return {"exp_avg": a(s.exp_avg), "exp_avg_sq": a(s.exp_avg_sq)}

    pool = {f.name: (ad(getattr(sm.pool, f.name)) if f.name.startswith("opt_")
                     else a(getattr(sm.pool, f.name)))
            for f in dataclasses.fields(sm.pool)}
    return dict(
        slab={f.name: a(getattr(sm.slab, f.name)) for f in dataclasses.fields(sm.slab)},
        opt={f.name: ad(getattr(sm.opt, f.name)) for f in dataclasses.fields(sm.opt)},
        gfeat=dict(val=a(sm.gfeat.val), lr=a(sm.gfeat.lr), **ad(sm.gfeat.opt)),
        mlp={k: a(getattr(sm.mlp, k)) for k in ("w1", "b1", "w2", "b2")},
        mlp_opt={k: ad(v) for k, v in sm.mlp_opt.items()},
        mlp_lr=a(sm.mlp_lr),
        pool=pool,
        cluster=dict(voxel_cls=a(sm.cluster_state.voxel_cls),
                     num_clusters=a(sm.cluster_state.num_clusters)),
        train_len=sm._train_len,
    )


class JaxKeyChain:
    """Densification uniforms replayed from the JAX SceneModel's key chain:
    PRNGKey(seed) -> split (mlp key, rng); per densify call
    ``_rand()`` splits rng; per LOD a split gives (k1, k2); u ~ U(k1) of
    shape (h, w) and the priorities ~ U(k2) of shape (h * w,).  The port
    asks for exactly these shapes in this order."""

    def __init__(self, seed: int):
        _, self.rng = jax.random.split(jax.random.PRNGKey(seed))
        self.calls = 0

    def __call__(self, shape):
        if self.calls % 8 == 0:          # a new densify call (4 LODs x 2)
            self.rng, self.densify_rng = jax.random.split(self.rng)
        if self.calls % 2 == 0:          # a new LOD
            self.densify_rng, k = jax.random.split(self.densify_rng)
            self.k1, self.k2 = jax.random.split(k)
            key = self.k1
        else:
            key = self.k2
        self.calls += 1
        return t(jax.random.uniform(key, shape))


def jax_frontend_state(fe) -> dict:
    """A JAX ``Frontend``'s state as the dict of numpy arrays that
    ``artdeco_tpu_torch.vslam.state_io.frontend_state_from_numpy`` takes."""
    a = np.asarray
    ks, tr = fe.keyframes, fe.tracker
    k = len(ks)
    emb = tr.last_embedding
    return dict(
        keyframes=dict(
            n_size=k, dataset_idx=ks.dataset_idx[:k].copy(), timestamp=ks.timestamp[:k].copy(),
            T_WC=ks.T_WC[:k].copy(), img=[a(ks._img[i]) for i in range(k)],
            X=[a(ks._X[i]) for i in range(k)], C=[a(ks._C[i]) for i in range(k)],
            N=[a(ks._N[i]) for i in range(k)],
            embeddings={i: (a(f), a(p)) for i, (f, p) in ks._embeddings.items()}),
        tracker=dict(idx_f2k=None if tr.idx_f2k is None else a(tr.idx_f2k),
                     last_dist=tr.last_dist, K_slam=a(tr.K_slam), emb_kf_idx=tr._emb_kf_idx,
                     last_embedding=None if emb is None else (a(emb[0]), a(emb[1]))),
        frontend=dict(last_T_WC=a(fe.last_T_WC), frame_id=fe.frame_id,
                      lost_number=fe.lost_number,
                      frames_info=[(f, ts, i, a(T)) for f, ts, i, T in fe.frames_info]),
    )


def jax_backend_state(bk) -> dict:
    """A JAX ``Backend``'s factor graph and retrieval database as the dict
    of numpy arrays that ``artdeco_tpu_torch.vslam.state_io.
    backend_state_from_numpy`` takes."""
    fg, db = bk.factor_graph, bk.retrieval
    n = fg.n_directed
    a = np.asarray
    return dict(
        factor_graph=dict(
            n_directed=n, ii=list(fg.ii), jj=list(fg.jj), e_ii=fg.e_ii.copy(),
            e_jj=fg.e_jj.copy(), e_valid=fg.e_valid.copy(),
            idx=a(fg._dev_edges["idx"])[:n], vm=a(fg._dev_edges["vm"])[:n],
            q=a(fg._dev_edges["q"])[:n]),
        retrieval=dict(
            centroids=None if db.centroids is None else db.centroids.copy(),
            ivf={c: (list(v[0]), [a(x) for x in v[1]]) for c, v in db.ivf.items()},
            image_norms=list(db.image_norms), kf_counter=db.kf_counter,
            sim={i: dict(r) for i, r in db.sim_graph.sim.items()},
            pending=None if db._pending is None else [a(x) for x in db._pending]),
    )


def assert_same_keypoints(ka, sa, kb, tol: float) -> int:
    """Two detectors' keypoints (P, 2) are the same set, and where the rows
    differ in order, each row of ``kb`` sits where ``ka`` has a score within
    ``tol`` of its own (a swap of near-tied scores ``sa``).  Returns the
    number of rows out of place."""
    ka, kb, sa = np.asarray(ka), np.asarray(kb), np.asarray(sa)
    assert sorted(map(tuple, ka.tolist())) == sorted(map(tuple, kb.tolist()))
    pos = {tuple(k): i for i, k in enumerate(ka.tolist())}
    moved = [(i, pos[tuple(k)]) for i, k in enumerate(kb.tolist()) if pos[tuple(k)] != i]
    for i, j in moved:
        assert abs(float(sa[i]) - float(sa[j])) <= tol, (i, j, sa[i], sa[j])
    return len(moved)
