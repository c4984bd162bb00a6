"""The port's pose-graph GN (``vslam/global_opt.py``) against the JAX package's.

The same numpy inputs go through both on the CPU: the per-edge terms on
random edges, the dense GN on the problems of ``tests/test_global_opt.py``,
the block-sparse PCG against JAX's and against the port's dense solver
(also on a chain above ``DENSE_POSE_LIMIT``), ``point_stride`` 4, and the
edge store's capacity growth.

Tolerances (from the measured JAX <-> torch gap): per-edge terms within
1e-5 relative to each block's largest entry (the sums over points run in
another order); poses within 1e-4 in translation and quaternion, where
the JAX package's and the port's fixed-order sums round differently and
ten GN iterations carry it.  The sparse solver agrees with the dense one
within the JAX package's own 5e-3 in the Sim(3) log
(``test_sparse_solver_matches_dense``), and with JAX's sparse solver
within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from artdeco_tpu.geometry import lie as jlie
from artdeco_tpu.vslam import global_opt as jgo
from artdeco_tpu_torch.vslam import global_opt as go
from test_global_opt import F, H, K, W, _build_problem, _pose_err
from torch_parity import CPU, n, t, torch_threads  # noqa: F401

POSE_TOL = 1e-4


def _sim3(xi):
    return np.asarray(jlie.sim3_exp(jnp.asarray(xi, jnp.float32)))


def _perturb(T_gt, rng, scale, fixed=1):
    T0 = T_gt.copy()
    for i in range(fixed, len(T_gt)):
        d = (scale * rng.randn(7)).astype(np.float32)
        T0[i] = np.asarray(jlie.sim3_mul(jlie.sim3_exp(jnp.asarray(d)), jnp.asarray(T_gt[i])))
    return T0


def _both(solver_j, solver_t, T0, prob, **kw):
    Xp, Cp, ii, jj, idx_p, vm_p, Q_p, ev, used = prob
    arrays = (T0, Xp, Cp, K, ii, jj, idx_p, vm_p, Q_p, ev, used)
    Tj = np.asarray(solver_j(*(jnp.asarray(a) for a in arrays), H, W, **kw))
    Tt = n(solver_t(*(t(a) for a in arrays), H, W, **kw))
    return Tj, Tt


def test_edge_terms_match_jax():
    rng = np.random.RandomState(0)
    P, hw, c = 3, H * W, 5
    Xs = np.concatenate([rng.randn(P, hw, 2) * 0.5,
                         rng.uniform(0.5, 3.0, (P, hw, 1))], -1).astype(np.float32)
    Xs[0, :7, 2] = -1.0                                 # behind the camera
    Cs = rng.uniform(-0.5, 3.0, (P, hw, 1)).astype(np.float32)
    ii = rng.randint(0, P, c).astype(np.int32)
    jj = ((ii + 1 + rng.randint(0, P - 1, c)) % P).astype(np.int32)
    idx = rng.randint(0, hw, (c, hw)).astype(np.int32)
    vm = rng.rand(c, hw) > 0.2
    Q = rng.uniform(0.0, 4.0, (c, hw, 1)).astype(np.float32)
    ev = np.asarray([True, True, True, True, False])
    T = np.stack([_sim3(0.1 * rng.randn(7)) for _ in range(P)])
    kw = dict(z_eps=1e-6, sigma_pixel=1.0, sigma_depth=10.0, C_thresh=0.0, Q_thresh=1.5)
    for stride in (1, 4):
        js = jax.vmap(lambda a, b, d, e, f, g: jgo._edge_static(
            jnp.asarray(Xs), jnp.asarray(Cs), a, b, d, e, f, edge_valid=g,
            point_stride=stride, **kw))(
            jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(idx[:, ::stride]),
            jnp.asarray(vm[:, ::stride]), jnp.asarray(Q[:, ::stride]), jnp.asarray(ev))
        ts = go._edge_static(t(Xs), t(Cs), t(ii).long(), t(jj).long(), t(idx[:, ::stride]),
                             t(vm[:, ::stride]), t(Q[:, ::stride]), edge_valid=t(ev),
                             point_stride=stride, **kw)
        for a, b in zip(js, ts):
            np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-6, atol=1e-7)
        ind = np.where(vm[:, ::stride], idx[:, ::stride], 0)
        jt = jax.vmap(lambda a, b, d, zl, wp, wd: jgo._edge_terms(
            jnp.asarray(T), jnp.asarray(Xs), jnp.asarray(K), a, b, d, zl, wp, wd, H, W, -10,
            1e-6, point_stride=stride))(jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(ind),
                                        *js)
        tt = go._edge_terms(t(T), t(Xs), t(K), t(ii).long(), t(jj).long(), t(ind), *ts, H, W,
                            -10, 1e-6, point_stride=stride)
        for a, b in zip(jt, tt):
            a, b = np.asarray(a), n(b)
            scale = np.abs(a).reshape(c, -1).max(1)
            err = np.abs(a - b).reshape(c, -1).max(1)
            assert (err <= 1e-5 * np.maximum(scale, 1e-12)).all(), (stride, err, scale)
        assert np.abs(np.asarray(jt[0])[4]).max() == 0.0     # the padding edge


def _recover_problem():
    xis = [np.zeros(7), np.asarray([0.05, -0.02, 0.03, 0.02, -0.01, 0.015, 0.01]),
           np.asarray([-0.04, 0.03, 0.06, -0.015, 0.02, -0.01, -0.02])]
    T_gt = np.stack([_sim3(x) for x in xis])
    prob = _build_problem(T_gt, [(0, 1), (1, 0), (1, 2), (2, 1)], P=4, E=8)
    T0 = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (4, 1))
    T0[0] = T_gt[0]
    for i in (1, 2):
        d = np.asarray([0.15, -0.1, 0.2, 0.05, -0.1, 0.075, 0.075], np.float32)
        T0[i] = np.asarray(jlie.sim3_mul(jlie.sim3_exp(jnp.asarray(d * (1 if i == 1 else -1))),
                                         jnp.asarray(T_gt[i])))
    return T_gt, T0, prob, dict(max_iter=10, delta_thresh=1e-8, sigma_pixel=1.0,
                                sigma_depth=10.0, Q_thresh=1.5, chunk=8)


def _shift_problem():
    tx = 3.0 * 2.0 / F
    T_gt = np.stack([np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32),
                     np.asarray([tx, 0, 0, 0, 0, 0, 1, 1], np.float32)])
    prob = _build_problem(T_gt, [(0, 1), (1, 0)], P=2, E=8)
    T0 = T_gt.copy()
    d = np.asarray([0.08, -0.05, 0.1, 0.03, -0.05, 0.04, 0.04], np.float32)
    T0[1] = np.asarray(jlie.sim3_mul(jlie.sim3_exp(jnp.asarray(d)), jnp.asarray(T_gt[1])))
    return T_gt, T0, prob, dict(max_iter=10, delta_thresh=1e-10, chunk=8)


@pytest.mark.parametrize("make", [_recover_problem, _shift_problem],
                         ids=["recovers_poses", "exact_integer_shift"])
def test_dense_gn_matches_jax(make):
    T_gt, T0, prob, kw = make()
    Tj, Tt = _both(jgo.gauss_newton_calib, go.gauss_newton_calib, T0, prob, **kw)
    np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)
    np.testing.assert_array_equal(Tt[0], T0[0])           # pinned
    for i in range(1, len(T_gt)):
        assert _pose_err(Tt[i], T_gt[i]) < 0.45 * _pose_err(T0[i], T_gt[i])


def test_sparse_gn_matches_jax_and_dense():
    rng = np.random.RandomState(0)
    T_gt = np.stack([np.zeros(8, np.float32) + _sim3(np.zeros(7))]
                    + [_sim3(0.04 * rng.randn(7)) for _ in range(3)])
    edges = [(i, i + 1) for i in range(3)] + [(i + 1, i) for i in range(3)]
    prob = _build_problem(T_gt, edges, P=4, E=8)
    T0 = _perturb(T_gt, rng, 0.1)
    kw = dict(max_iter=8, delta_thresh=1e-10, chunk=8)
    Tj, Tt = _both(jgo.gauss_newton_calib_sparse, go.gauss_newton_calib_sparse, T0, prob,
                   **kw)
    np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)
    _, Td = _both(lambda *a, **k: np.zeros(1), go.gauss_newton_calib, T0, prob, **kw)
    for i in range(4):
        assert _pose_err(Td[i], Tt[i]) < 5e-3, i


def chain_problem(n_poses: int, seed: int = 1, hub: int = 16):
    """A zigzag of exact 2-pixel x-translations (as in
    ``test_sparse_solver_large_pose_count``) joined to its neighbours at
    1 and 4 poses and, every ``hub`` poses, to pose 0; and its perturbed
    start.  The hubs keep the dense float32 solve well conditioned: on the
    bare chain the dense solves of the two packages differ by 0.09 in the
    Sim(3) log after 4 iterations, the PCG ones by 7e-3."""
    rng = np.random.RandomState(seed)
    tx = 2.0 * 2.0 / F
    T_gt = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (n_poses, 1))
    T_gt[:, 0] = (np.arange(n_poses) % 4) * tx
    edges = []
    for step in (1, 4):
        for i in range(n_poses - step):
            edges += [(i, i + step), (i + step, i)]
    for k in range(hub, n_poses, hub):
        edges += [(0, k), (k, 0)]
    E = 1
    while E < len(edges):
        E *= 2
    return T_gt, _perturb(T_gt, rng, 0.08), _build_problem(T_gt, edges, P=n_poses, E=E)


def test_sparse_gn_above_dense_limit():
    """P = 264 > DENSE_POSE_LIMIT: the port's PCG against JAX's PCG (within
    1e-4; measured 1.1e-5 in the Sim(3) log) and against the port's dense
    solve of the same system (within 5e-4 in the log; measured 9.3e-5)."""
    n_poses = 264
    assert n_poses > go.FactorGraph.DENSE_POSE_LIMIT
    T_gt, T0, prob = chain_problem(n_poses)
    kw = dict(max_iter=4, delta_thresh=1e-10, chunk=32)
    Tj, Tt = _both(jgo.gauss_newton_calib_sparse, go.gauss_newton_calib_sparse, T0, prob,
                   **kw)
    np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)
    _, Td = _both(lambda *a, **k: np.zeros(1), go.gauss_newton_calib, T0, prob, **kw)
    errs = np.asarray([_pose_err(Td[i], Tt[i]) for i in range(n_poses)])
    assert errs.max() < 5e-4, errs.max()
    e0 = np.median([_pose_err(T0[i], T_gt[i]) for i in range(1, n_poses)])
    e1 = np.median([_pose_err(Tt[i], T_gt[i]) for i in range(1, n_poses)])
    assert e1 < 0.05 * e0, (e0, e1)


def test_point_stride_4_matches_jax():
    rng = np.random.RandomState(7)
    xis = [np.zeros(7), np.asarray([0.05, -0.02, 0.03, 0.02, -0.01, 0.015, 0.01]),
           np.asarray([-0.04, 0.03, 0.06, -0.015, 0.02, -0.01, -0.02])]
    T_gt = np.stack([_sim3(x) for x in xis])
    edges = [(0, 1), (1, 0), (1, 2), (2, 1), (0, 2), (2, 0)]
    Xp, Cp, ii, jj, idx_p, vm_p, Q_p, ev, used = _build_problem(T_gt, edges, P=4, E=8)
    Xp[:3] *= (1.0 + 0.01 * rng.randn(3, H * W, 1)).astype(np.float32)   # depth noise
    T0 = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (4, 1))
    T0[:3] = _perturb(T_gt, rng, 0.1)
    prob = (Xp, Cp, ii, jj, idx_p, vm_p, Q_p, ev, used)
    Tj, Tt = _both(jgo.gauss_newton_calib, go.gauss_newton_calib, T0, prob,
                   max_iter=10, delta_thresh=1e-8, chunk=8, point_stride=4)
    np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)


def test_factor_graph_capacity_growth():
    """The port's edge store: capacities grow and keep every row, as the
    JAX package's (``test_factor_graph_capacity_growth``)."""
    cfg = {"local_opt": {
        "pin": 1, "window_size": 1e6, "C_conf": 0.0, "Q_conf": 1.5,
        "min_match_frac": 0.1, "pixel_border": -10, "depth_eps": 1e-6,
        "sigma_pixel": 1.0, "sigma_depth": 10.0, "max_iters": 3, "delta_norm": 1e-8,
    }}
    fgs = (go.FactorGraph(cfg, runner=None, keyframes=None, K=K, hw=(4, 5), device=CPU),
           jgo.FactorGraph(cfg, runner=None, keyframes=None, K=K, hw=(4, 5)))
    rng = np.random.RandomState(0)
    rows = []
    for e in range(40):
        for (i, j) in ((e, e + 1), (e + 1, e)):
            row = (rng.randint(0, 20, 20), rng.rand(20) > 0.5, rng.rand(20).astype(np.float32))
            rows.append(row)
            for fg in fgs:
                fg._append_directed(i, j, *row)
    fg, jfg = fgs
    assert fg.n_directed == jfg.n_directed == 80
    assert (fg._cap, fg._dev_ecap) == (jfg._cap, jfg._dev_ecap)
    for k in ("e_ii", "e_jj", "e_valid"):
        np.testing.assert_array_equal(getattr(fg, k), getattr(jfg, k))
    for k in ("idx", "vm", "q"):
        np.testing.assert_array_equal(n(fg._dev_edges[k]), np.asarray(jfg._dev_edges[k]))
    np.testing.assert_array_equal(n(fg._dev_edges["idx"][:80]), np.stack([r[0] for r in rows]))
