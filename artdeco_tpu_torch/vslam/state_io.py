"""Carry a tracking frontend's state across from numpy arrays.

``frontend_state_from_numpy`` turns the state of a frontend (a JAX
``Frontend`` mid-stream, for instance), given as a dict of numpy arrays,
into the port's, and ``load_frontend_state`` installs it into a port
``Frontend``; the next frames then track from where the other left off.
The dict's layout:

    keyframes: {n_size, dataset_idx (n,), timestamp (n,), T_WC (n, 8),
                img [(3, H, W)], X [(HW, 3)], C [(HW, 1)], N [()],
                embeddings {index: (feat, pos)}}
    tracker:   {idx_f2k (1, HW) or None, last_dist, K_slam (3, 3),
                emb_kf_idx, last_embedding (feat, pos) or None}
    frontend:  {last_T_WC (8,), frame_id, lost_number,
                frames_info [(frame_id, timestamp, kf_index, T_rel (8,))]}

``backend_state_from_numpy`` / ``load_backend_state`` do the same for a
backend: its factor graph's edge store and its retrieval database.

    factor_graph: {n_directed, ii [..], jj [..] (kept pairs),
                   e_ii, e_jj, e_valid (cap,), idx (n, HW) int, vm (n, HW)
                   bool, q (n, HW) f32 (the first n_directed device rows)}
    retrieval:    {centroids (C, D) or None, ivf {c: (ids [..], sigs
                   [(D,)])}, image_norms [..], kf_counter, sim {i: {j: s}},
                   pending [(n, D)] or None}

This module only sees numpy: converting framework arrays is the caller's
job.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FrontendState:
    keyframes: dict
    tracker: dict
    frontend: dict


def _dev(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _token(emb):
    """An embedding (feat, pos) on the host, as the runner keeps it."""
    return None if emb is None else (_dev(emb[0], "cpu", torch.float32),
                                     _dev(emb[1], "cpu", torch.int32))


def frontend_state_from_numpy(d: dict, device) -> FrontendState:
    """The port's frontend state on ``device`` from a dict of numpy arrays
    (layout in the module docstring)."""
    kd, td, fd = d["keyframes"], d["tracker"], d["frontend"]
    n = int(kd["n_size"])
    keyframes = dict(
        n_size=n,
        dataset_idx=np.asarray(kd["dataset_idx"], np.int32)[:n],
        timestamp=np.asarray(kd["timestamp"], np.float64)[:n],
        T_WC=np.asarray(kd["T_WC"], np.float32)[:n],
        img=[_dev(x, device, torch.float32) for x in kd["img"]],
        X=[_dev(x, device, torch.float32) for x in kd["X"]],
        C=[_dev(x, device, torch.float32) for x in kd["C"]],
        N=[_dev(x, device, torch.int32) for x in kd["N"]],
        embeddings={int(i): _token(e) for i, e in kd["embeddings"].items()},
    )
    idx = td["idx_f2k"]
    tracker = dict(
        idx_f2k=None if idx is None else _dev(idx, device, torch.int64),
        last_dist=float(td["last_dist"]),
        K_slam=_dev(td["K_slam"], device, torch.float32),
        emb_kf_idx=int(td["emb_kf_idx"]),
        last_embedding=_token(td["last_embedding"]),
    )
    frontend = dict(
        last_T_WC=_dev(fd["last_T_WC"], device, torch.float32),
        frame_id=int(fd["frame_id"]),
        lost_number=int(fd["lost_number"]),
        frames_info=[[int(a), float(b), int(c), _dev(T, device, torch.float32)]
                     for a, b, c, T in fd["frames_info"]],
    )
    return FrontendState(keyframes=keyframes, tracker=tracker, frontend=frontend)


def load_frontend_state(fe, state: FrontendState) -> None:
    """Install ``state`` into the port ``Frontend`` ``fe`` (its keyframe
    store, its tracker and its own counters)."""
    ks, kd = fe.keyframes, state.keyframes
    n = kd["n_size"]
    ks.n_size = n
    ks.dataset_idx[:n] = kd["dataset_idx"]
    ks.timestamp[:n] = kd["timestamp"]
    ks.T_WC[:n] = kd["T_WC"]
    for i in range(n):
        ks._img[i], ks._X[i], ks._C[i], ks._N[i] = (kd["img"][i], kd["X"][i], kd["C"][i],
                                                   kd["N"][i])
    ks._embeddings = dict(kd["embeddings"])
    tr, td = fe.tracker, state.tracker
    tr.idx_f2k = td["idx_f2k"]
    tr.last_dist = td["last_dist"]
    tr.K_slam = td["K_slam"]
    tr._emb_kf_idx = td["emb_kf_idx"]
    tr.last_embedding = td["last_embedding"]
    for k, v in state.frontend.items():
        setattr(fe, k, v)


def backend_state_from_numpy(d: dict, device) -> dict:
    """The port's backend state on ``device`` from a dict of numpy arrays
    (layout in the module docstring)."""
    fg, rd = d["factor_graph"], d["retrieval"]
    n = int(fg["n_directed"])
    factor_graph = dict(
        n_directed=n, ii=[int(i) for i in fg["ii"]], jj=[int(j) for j in fg["jj"]],
        e_ii=np.array(fg["e_ii"], np.int32), e_jj=np.array(fg["e_jj"], np.int32),
        e_valid=np.array(fg["e_valid"], bool),
        idx=_dev(np.asarray(fg["idx"])[:n], device, torch.int32),
        vm=_dev(np.asarray(fg["vm"])[:n], device, torch.bool),
        q=_dev(np.asarray(fg["q"])[:n], device, torch.float32))
    retrieval = dict(
        centroids=None if rd["centroids"] is None else np.array(rd["centroids"], np.float32),
        ivf={int(c): ([int(i) for i in ids], [np.array(x, np.float32) for x in sigs])
             for c, (ids, sigs) in rd["ivf"].items()},
        image_norms=[float(x) for x in rd["image_norms"]],
        kf_counter=int(rd["kf_counter"]),
        sim={int(i): {int(j): float(v) for j, v in row.items()} for i, row in rd["sim"].items()},
        pending=None if rd["pending"] is None else [np.array(x, np.float32)
                                                    for x in rd["pending"]])
    return dict(factor_graph=factor_graph, retrieval=retrieval)


def load_backend_state(bk, state: dict) -> None:
    """Install ``state`` into the port ``Backend`` ``bk``: the factor
    graph's edge store (device rows at the JAX package's capacities) and
    the retrieval database."""
    fg, fd = bk.factor_graph, state["factor_graph"]
    n = fd["n_directed"]
    fg.ii, fg.jj = list(fd["ii"]), list(fd["jj"])
    fg.e_ii, fg.e_jj, fg.e_valid = fd["e_ii"].copy(), fd["e_jj"].copy(), fd["e_valid"].copy()
    fg._cap = fg.e_ii.shape[0]
    fg.n_directed = 0
    fg._ensure_dev_capacity(n)
    for key in ("idx", "vm", "q"):
        fg._dev_edges[key][:n] = fd[key]
    fg.n_directed = n

    db, rd = bk.retrieval, state["retrieval"]
    from collections import defaultdict

    db.centroids = rd["centroids"]
    db.ivf = defaultdict(lambda: [[], []])
    for c, (ids, sigs) in rd["ivf"].items():
        db.ivf[c] = [list(ids), list(sigs)]
    db.image_norms = list(rd["image_norms"])
    db.kf_counter = rd["kf_counter"]
    db.sim_graph.sim = defaultdict(dict, {i: dict(r) for i, r in rd["sim"].items()})
    db._pending = None if rd["pending"] is None else list(rd["pending"])
