"""Factor graph + global Sim(3) Gauss-Newton pose optimization.

Port of ``artdeco_tpu/vslam/global_opt.py``: the edge store with two-way
matching (``FactorGraph``), the dense pose-graph GN
(``gauss_newton_calib``) and the block-sparse PCG GN for large pose counts
(``gauss_newton_calib_sparse``).  The JAX package writes all of this in
plain XLA, so the port is plain PyTorch on tensors: no hand kernel.

What the tensor form changes, and why the results are the JAX package's:

* **Fixed-order sums.**  The normal equations sum 7x7 blocks over edges
  into the poses they join.  A scatter-add with repeated indices is an
  atomic add on CUDA, whose order (and so its rounding) varies from run to
  run.  Here every such sum is a product with a 0/1 incidence matrix of
  the edges: the block diagonal by pose, the off-diagonal blocks by
  unordered pose pair (written once each), the gradient and the PCG
  matvec by the signed incidence.  A matrix product sums in a fixed order.
* **Data-dependent loops.**  The GN loop (``max_iter``, ``delta_thresh``)
  and the PCG loop (``pcg_iters``, the residual test) stop on device
  scalars.  Both run as host loops whose iterate is frozen by a device
  flag once the JAX loop's condition fails, which leaves the JAX loop's
  result; the host reads the flag once per block of iterations.
* **Padding.**  P (poses) and E (directed edges) keep the JAX package's
  power-of-two pads, padding poses pinned and the same 1e-6 jitter, so the
  linear system is the same.  Edge terms are computed only over the edges
  up to the last real one: a padding edge's terms are exact zeros.
* **Precision.**  Products and the solve run without TF32.
* **Edge sharding** (``gauss_newton_calib_sharded``, the JAX package's
  ``shard_map`` over edges): over a ``parallel/mesh.Mesh``, each slot
  builds the statics and the (H, g) partial sums of its contiguous slice
  of the edges on its device; the partials are summed on the home device
  in slot order once per GN iteration, and the dense solve runs there
  (JAX solves it on every device, with the same result).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from artdeco_tpu_torch import trace
from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.geometry import projection as proj
from artdeco_tpu_torch.vslam.tracker import full_f32

D = 7
GN_BLOCK = 5       # GN iterations between host reads of the stop flag
PCG_BLOCK = 32     # PCG iterations between host reads of the stop flag


# ---------------------------------------------------------------------------
# Per-edge terms
# ---------------------------------------------------------------------------

def _clamp_step(dx, max_step: float = 1.0):
    """Per-pose trust region: cap each pose's tangent step norm at
    ``max_step``; shorter steps pass unchanged."""
    nrm = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
    return dx * torch.clamp_max(max_step / torch.clamp_min(nrm, 1e-12), 1.0)


def _edge_static(Xs, Cs, i_idx, j_idx, idx_ii2jj, valid_match, Q, z_eps, sigma_pixel,
                 sigma_depth, C_thresh, Q_thresh, edge_valid, point_stride=1):
    """Iteration-invariant data of a batch of edges.

    Xs (P, HW, 3), Cs (P, HW, 1); i_idx, j_idx, edge_valid (c,);
    idx_ii2jj, valid_match (c, m) and Q (c, m, 1) already at the point
    stride.  Returns (zi_log, sqrt_w_pix, sqrt_w_dep), each (c, m), the
    weights zeroed wherever the static validity gate fails."""
    ind = torch.where(valid_match, idx_ii2jj, 0).long()
    zi = Xs[i_idx[:, None], ind, 2]
    q = Q[..., 0]
    ci = Cs[i_idx[:, None], ind, 0]
    cj = Cs[:, ::point_stride, 0][j_idx]
    valid_zi = zi > z_eps
    valid = (valid_match & (q > Q_thresh) & (ci > C_thresh) & (cj > C_thresh)
             & valid_zi & edge_valid[:, None])
    zi_log = torch.where(valid_zi, torch.log(torch.where(valid_zi, zi, 1.0)), 0.0)
    sq = torch.sqrt(q)
    sqrt_w_pix = torch.where(valid, (1.0 / sigma_pixel) * sq, 0.0)
    sqrt_w_dep = torch.where(valid, (1.0 / sigma_depth) * sq, 0.0)
    return zi_log, sqrt_w_pix, sqrt_w_dep


def _huber(r):
    r_abs = torch.abs(r)
    return torch.where(r_abs < 1.345, 1.0, 1.345 / torch.clamp_min(r_abs, 1e-12))


def _edge_terms(T_wc, Xs, K, i_idx, j_idx, idx_ii2jj, zi_log, sqrt_w_pix0, sqrt_w_dep0,
                height, width, pixel_border, z_eps, point_stride=1):
    """Hessian block and gradients of a batch of edges (the reference's
    calib_proj_kernel math).

    ``idx_ii2jj`` (c, m) holds the gated indices (0 where the match is
    invalid), the other per-point inputs come from :func:`_edge_static`.
    Returns (Hjj (c, 7, 7), gi, gj (c, 7)); Hii == Hjj and
    Hij == Hji == -Hjj."""
    Ti, Tj = T_wc[i_idx], T_wc[j_idx]
    Tij = lie.sim3_rel(Ti, Tj)
    Xj = Xs[:, ::point_stride][j_idx]
    Xj_Ci = lie.sim3_act(Tij, Xj)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    valid_z = Xj_Ci[..., 2] > z_eps
    zj = torch.where(valid_z, Xj_Ci[..., 2], 1.0)
    zj_inv = torch.where(valid_z, 1.0 / zj, 0.0)
    zj_log = torch.where(valid_z, torch.log(zj), 0.0)
    x_div_z = Xj_Ci[..., 0] * zj_inv
    y_div_z = Xj_Ci[..., 1] * zj_inv
    u = fx * x_div_z + cx
    v = fy * y_div_z + cy
    ind = idx_ii2jj.long()
    u_t = (ind % width).float()
    v_t = (ind // width).float()
    valid_u = (u > pixel_border) & (u < width - 1 - pixel_border)
    valid_v = (v > pixel_border) & (v < height - 1 - pixel_border)
    err = torch.stack([u - u_t, v - v_t, zj_log - zi_log], dim=-1)   # (c, m, 3)

    gate = valid_u & valid_v & valid_z
    swp = torch.where(gate, sqrt_w_pix0, 0.0)
    swd = torch.where(gate, sqrt_w_dep0, 0.0)
    w = torch.stack([_huber(swp * err[..., 0]) * swp * swp,
                     _huber(swp * err[..., 1]) * swp * swp,
                     _huber(swd * err[..., 2]) * swd * swd], dim=-1)

    zeros, ones = torch.zeros_like(x_div_z), torch.ones_like(x_div_z)
    J_u = torch.stack([fx * zj_inv, zeros, -fx * x_div_z * zj_inv,
                       -fx * x_div_z * y_div_z, fx * (1 + x_div_z * x_div_z),
                       -fx * y_div_z, zeros], dim=-1)
    J_v = torch.stack([zeros, fy * zj_inv, -fy * y_div_z * zj_inv,
                       -fy * (1 + y_div_z * y_div_z), fy * x_div_z * y_div_z,
                       fy * x_div_z, zeros], dim=-1)
    J_z = torch.stack([zeros, zeros, zj_inv, y_div_z, -x_div_z, zeros, ones], dim=-1)
    J_loc = torch.stack([J_u, J_v, J_z], dim=-2)                       # (c, m, 3, 7)
    # world-frame tangent of pose j via Adj_i^{-T}; pose i gets the negative
    Jj = lie.sim3_adj_inv_transpose_apply(Ti[:, None, None, :], J_loc)
    c = Jj.shape[0]
    Jf = Jj.reshape(c, -1, D)
    Hjj = torch.bmm((w[..., None] * Jj).reshape(c, -1, D).transpose(1, 2), Jf)
    gj = torch.bmm((w * err).reshape(c, 1, -1), Jf)[:, 0]
    return Hjj, -gj, gj


# ---------------------------------------------------------------------------
# The solvers
# ---------------------------------------------------------------------------

def _chunk_for(E: int, chunk: int) -> int:
    """The largest divisor of E not above ``chunk`` (JAX's edge chunk)."""
    chunk = max(1, min(chunk, E))
    while E % chunk:
        chunk -= 1
    return chunk


class _Edges:
    """One solve's edges: the incidence matrices of the real ones and their
    iteration-invariant terms."""

    def __init__(self, P, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid, *, z_eps,
                 sigma_pixel, sigma_depth, C_thresh, Q_thresh, chunk, point_stride):
        dev = Xs.device
        E = ii.shape[0]
        self.chunk = _chunk_for(E, chunk)
        ev_host = edge_valid.detach().cpu().numpy().astype(bool)
        # the edges up to the last real one, the last chunk ragged (a
        # padding edge's terms are exact zeros: leaving them out changes
        # no sum)
        self.n = n = int(np.flatnonzero(ev_host).max()) + 1 if ev_host.any() else 0
        ii_h = ii.detach().cpu().numpy()[:n].astype(np.int64)
        jj_h = jj.detach().cpu().numpy()[:n].astype(np.int64)
        self.ii = torch.as_tensor(ii_h, device=dev)
        self.jj = torch.as_tensor(jj_h, device=dev)
        self.ev = edge_valid[:n].to(dev)
        self.point_stride = point_stride
        # incidences (fixed-order sums as matrix products): S (n, P) signed
        # (+1 at i, -1 at j) and U (n, P) unsigned (+1 at i and at j)
        S = np.zeros((n, P), np.float32)
        U = np.zeros((n, P), np.float32)
        rows = np.arange(n)
        np.add.at(S, (rows, ii_h), 1.0)
        np.add.at(S, (rows, jj_h), -1.0)
        np.add.at(U, (rows, ii_h), 1.0)
        np.add.at(U, (rows, jj_h), 1.0)
        # unordered pose pairs of the edges that join two poses
        a, b = np.minimum(ii_h, jj_h), np.maximum(ii_h, jj_h)
        off = a != b
        pairs, inv = np.unique(np.stack([a[off], b[off]], 1), axis=0, return_inverse=True)
        M = np.zeros((n, len(pairs)), np.float32)
        M[rows[off], inv.reshape(-1)] = 1.0
        self.S, self.U, self.M = (torch.as_tensor(x, device=dev) for x in (S, U, M))
        self.pairs = torch.as_tensor(pairs.reshape(-1, 2), device=dev)

        st = point_stride
        idx_s = idx_ii2jj[:n, ::st]
        vm_s = valid_match[:n, ::st]
        Q_s = Q[:n, ::st]
        parts = [_edge_static(Xs, Cs, self.ii[s:s + self.chunk], self.jj[s:s + self.chunk],
                              idx_s[s:s + self.chunk], vm_s[s:s + self.chunk],
                              Q_s[s:s + self.chunk], z_eps, sigma_pixel, sigma_depth,
                              C_thresh, Q_thresh, self.ev[s:s + self.chunk],
                              point_stride=st)
                 for s in range(0, n, self.chunk)]
        m = idx_s.shape[1]
        empty = torch.zeros(0, m, device=dev)
        self.zi_log, self.swp, self.swd = (
            torch.cat([p[k] for p in parts]) if parts else empty for k in range(3))
        self.ind = torch.where(vm_s, idx_s, 0)

    def blocks(self, T, Xs, K, height, width, pixel_border, z_eps):
        """(B (n, 7, 7), gj (n, 7)) at poses T, edge chunk by edge chunk."""
        Bs, gs = [], []
        for s in range(0, self.n, self.chunk):
            e = slice(s, s + self.chunk)
            B, _, gj = _edge_terms(T, Xs, K, self.ii[e], self.jj[e], self.ind[e],
                                   self.zi_log[e], self.swp[e], self.swd[e], height, width,
                                   pixel_border, z_eps, point_stride=self.point_stride)
            Bs.append(B)
            gs.append(gj)
        if not Bs:
            z = torch.zeros(0, D, device=T.device)
            return z.reshape(0, 1, D).expand(0, D, D), z
        return torch.cat(Bs), torch.cat(gs)

    def gradient(self, gj):
        """(P, 7): gi = -gj into pose i, gj into pose j."""
        return -(self.S.T @ gj)

    def diag(self, B):
        """(P, 7, 7): every edge's block into both of its poses."""
        return (self.U.T @ B.reshape(-1, D * D)).reshape(-1, D, D)

    def dense(self, B, P):
        """(P, P, 7, 7): +B into (i, i) and (j, j), -B into (i, j) and
        (j, i), summed by pose and by pose pair."""
        H = torch.zeros(P, P, D, D, device=B.device)
        idx = torch.arange(P, device=B.device)
        H[idx, idx] = self.diag(B)
        if self.pairs.shape[0]:
            off = (self.M.T @ B.reshape(-1, D * D)).reshape(-1, D, D)
            a, b = self.pairs[:, 0], self.pairs[:, 1]
            H[a, b] = -off
            H[b, a] = -off
        return H


def _solve_statics(kw):
    return {k: kw[k] for k in ("z_eps", "sigma_pixel", "sigma_depth", "C_thresh",
                               "Q_thresh", "chunk", "point_stride")}


def gauss_newton_calib(T_wc, Xs, Cs, K, ii, jj, idx_ii2jj, valid_match, Q, edge_valid,
                       pose_used, height: int, width: int, pixel_border: int = -10,
                       z_eps: float = 1e-6, sigma_pixel: float = 1.0,
                       sigma_depth: float = 10.0, C_thresh: float = 0.0,
                       Q_thresh: float = 1.5, max_iter: int = 10,
                       delta_thresh: float = 1e-8, num_fix: int = 1, chunk: int = 64,
                       point_stride: int = 1):
    """Global Sim(3) pose-graph GN with a dense solve.

    T_wc (P, 8) poses (the first ``num_fix`` and the unused ones pinned),
    Xs (P, HW, 3) ray-constrained pointmaps, Cs (P, HW, 1) average
    confidences, ii, jj (E,) directed edges (frame j's pixels matched into
    frame i), idx_ii2jj (E, HW) int, valid_match (E, HW) bool,
    Q (E, HW, 1), edge_valid (E,), pose_used (P,).  ``point_stride`` uses
    every stride-th target pixel.  Returns the poses (P, 8)."""
    kw = dict(locals())
    with full_f32():
        return _gn(False, **kw)


def gauss_newton_calib_sparse(T_wc, Xs, Cs, K, ii, jj, idx_ii2jj, valid_match, Q,
                              edge_valid, pose_used, height: int, width: int,
                              pixel_border: int = -10, z_eps: float = 1e-6,
                              sigma_pixel: float = 1.0, sigma_depth: float = 10.0,
                              C_thresh: float = 0.0, Q_thresh: float = 1.5,
                              max_iter: int = 10, delta_thresh: float = 1e-8,
                              num_fix: int = 1, chunk: int = 64, pcg_iters: int = None,
                              point_stride: int = 1):
    """Block-sparse GN for large pose counts: per-edge 7x7 blocks, solved by
    block-Jacobi preconditioned conjugate gradients (up to ``pcg_iters``,
    default max(128, 2P), per GN iteration).  Same arguments and semantics
    as :func:`gauss_newton_calib`."""
    kw = dict(locals())
    with full_f32():
        return _gn(True, **kw)


def gauss_newton_calib_sharded(mesh, axis: str, T_wc, Xs, Cs, K, ii, jj, idx_ii2jj,
                               valid_match, Q, edge_valid, pose_used, height: int,
                               width: int, pixel_border: int = -10, z_eps: float = 1e-6,
                               sigma_pixel: float = 1.0, sigma_depth: float = 10.0,
                               C_thresh: float = 0.0, Q_thresh: float = 1.5,
                               max_iter: int = 10, delta_thresh: float = 1e-8,
                               num_fix: int = 1, chunk: int = None, point_stride: int = 1):
    """:func:`gauss_newton_calib` with the edges sharded over ``mesh``'s
    ``axis``: slot d takes the d-th of n contiguous slices of the E edges
    (E % n must be 0; ``ValueError`` otherwise), ``chunk`` defaults to the
    slice, E // n.  The inputs are on the mesh's home device; so are the
    poses returned."""
    n = mesh.shape[axis]
    E = ii.shape[0]
    if E % n:
        raise ValueError(f"edge pad {E} not divisible by mesh axis {n}")
    if chunk is None:
        chunk = max(1, E // n)
    kw = dict(locals())
    del kw["n"], kw["E"], kw["axis"]
    with full_f32():
        return _gn(False, **kw)


def _gn(sparse: bool, *, T_wc, Xs, Cs, K, ii, jj, idx_ii2jj, valid_match, Q, edge_valid,
        pose_used, height, width, pixel_border, max_iter, delta_thresh, num_fix,
        pcg_iters=None, mesh=None, **statics):
    P = T_wc.shape[0]
    dev = T_wc.device
    st = _solve_statics(statics)
    if mesh is None:
        parts = [(_Edges(P, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, edge_valid, **st),
                  Xs, K)]
    else:
        # slot d: the d-th contiguous slice of the edges, built on its device
        m = ii.shape[0] // mesh.size
        parts = []
        for d in range(mesh.size):
            rep = lambda x: mesh.replicate(x, d)  # noqa: E731
            e = slice(d * m, (d + 1) * m)
            Xd = rep(Xs)
            parts.append((_Edges(P, Xd, rep(Cs), *(rep(a[e]) for a in (
                ii, jj, idx_ii2jj, valid_match, Q, edge_valid)), **st), Xd, rep(K)))
    free = pose_used.to(dev) & (torch.arange(P, device=dev) >= num_fix)
    if sparse and pcg_iters is None:
        pcg_iters = max(128, 2 * P)
    T = T_wc
    active = torch.ones((), dtype=torch.bool, device=dev)
    for it in range(max_iter):
        if it and it % GN_BLOCK == 0 and not bool(active):
            break
        if sparse:
            edges = parts[0][0]
            B, gj = edges.blocks(T, Xs, K, height, width, pixel_border, statics["z_eps"])
            dx = _pcg_step(edges, B, edges.gradient(gj), free, pcg_iters)
        else:
            # the normal equations: each part's partial sums, summed at home
            # in part order
            H = g = None
            for d, (edges, Xd, Kd) in enumerate(parts):
                Td = T if mesh is None else mesh.replicate(T, d)
                B, gj = edges.blocks(Td, Xd, Kd, height, width, pixel_border,
                                     statics["z_eps"])
                Hd, gd = edges.dense(B, P).to(dev), edges.gradient(gj).to(dev)
                H, g = (Hd, gd) if H is None else (H + Hd, g + gd)
            dx = _dense_step(H, g, free, P)
        dx = _clamp_step(dx)
        T_new = lie.sim3_normalize(lie.sim3_retr(T, dx))
        T = torch.where(active & free[:, None], T_new, T)
        active = active & (torch.linalg.vector_norm(dx) >= delta_thresh)
    return T


def _dense_step(H, g, free, P):
    Hd = H.permute(0, 2, 1, 3).reshape(P * D, P * D)
    pin = (~free).repeat_interleave(D)
    Hd = torch.where(pin[:, None] | pin[None, :], 0.0, Hd)
    Hd = Hd + torch.diag(torch.where(pin, 1.0, 1e-6))
    gd = torch.where(pin, 0.0, g.reshape(-1))
    dx = -torch.linalg.solve(Hd, gd)
    return torch.where(pin, 0.0, dx).reshape(P, D)


def _pcg_step(edges, B, g, free, pcg_iters):
    P = free.shape[0]
    B = B * edges.ev.float()[:, None, None]
    eye = torch.eye(D, device=B.device)
    Hdiag = edges.diag(B) + 1e-6 * eye
    Hdiag = torch.where(free[:, None, None], Hdiag, eye.expand(P, D, D))
    Minv = torch.linalg.inv(Hdiag)
    maskx = free[:, None].float()
    S, ii, jj = edges.S, edges.ii, edges.jj

    def matvec(x):
        x = x * maskx
        t = torch.bmm(B, (x[ii] - x[jj])[..., None])[..., 0]
        return (S.T @ t + 1e-6 * x) * maskx

    def precond(r):
        return torch.bmm(Minv, r[..., None])[..., 0] * maskx

    b = -g * maskx
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    tol = 1e-12 * torch.clamp_min(torch.sum(b * b), 1e-30)
    for k in range(pcg_iters):
        if k and k % PCG_BLOCK == 0 and not bool(torch.sum(r * r) > tol):
            break
        go = torch.sum(r * r) > tol
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond(r_n)
        rz_n = torch.sum(r_n * z_n)
        beta = rz_n / torch.clamp_min(rz, 1e-30)
        p_n = z_n + beta * p
        x, r, z, p, rz = (torch.where(go, a, o) for a, o in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
    return x * maskx


# ---------------------------------------------------------------------------
# Host-side factor graph
# ---------------------------------------------------------------------------

def _pow2(n, lo=8):
    c = lo
    while c < n:
        c *= 2
    return c


class FactorGraph(trace.Timed):
    """Edge store with two-way matching (``global_opt.py:563-1161`` of the
    JAX package, without its AOT prewarm); ``enable_mesh`` shards the dense
    GN's edges over a mesh.

    Per-edge scalars (``e_ii``, ``e_jj``, ``e_valid``) are host numpy at a
    power-of-two capacity; the O(HW) payloads (match index map, validity,
    Q) live only on the device, in ``_dev_edges``.  Each kept pair takes
    two rows, one per direction.  ``timers`` sums wall time per stage
    ("fg.*", "gn.*"); with ``sync_timing`` the device is synchronised at
    each stage boundary."""

    # dense assembly is O(P^2); above this many poses the PCG solver runs
    DENSE_POSE_LIMIT = 256

    def __init__(self, cfg: dict, runner, keyframes, K, hw, *, device=None):
        self.cfg = cfg["local_opt"]
        self.runner = runner
        self.keyframes = keyframes
        self.device = resolve(device)
        self.K = np.asarray(K, np.float32)
        self.h, self.w = hw
        self.ii: list[int] = []       # undirected kept pairs (bookkeeping)
        self.jj: list[int] = []
        self._cap = 16
        self.n_directed = 0
        self.e_ii = np.zeros(self._cap, np.int32)
        self.e_jj = np.zeros(self._cap, np.int32)
        self.e_valid = np.zeros(self._cap, bool)
        self._dev_edges: dict = {}    # 'idx' int32, 'vm' bool, 'q' f32, (capE, HW)
        self._dev_ecap = 0
        self.timers = trace.Timers()
        self.solves: list = []        # (P, E, n_edges) of each solve
        self.match_rows = 0           # rows matched by add_factors (K3 launches)
        self.mesh = None              # enable_mesh
        self.mesh_axis = "dp"
        self.sharded_solves = 0       # solves that ran gauss_newton_calib_sharded

    def enable_mesh(self, mesh, axis: str = "dp") -> None:
        """Shard the edges of later dense GN solves over ``mesh``'s ``axis``
        (``gauss_newton_calib_sharded``); ``None`` turns it off."""
        self.mesh = mesh
        self.mesh_axis = axis

    def __len__(self):
        return len(self.ii)

    def _ensure_capacity(self, add: int):
        need = self.n_directed + add
        if need <= self._cap:
            return
        new_cap = _pow2(need, lo=self._cap * 2)

        def grow(a, dtype):
            out = np.zeros(new_cap, dtype)
            out[: self.n_directed] = a[: self.n_directed]
            return out

        self.e_ii = grow(self.e_ii, np.int32)
        self.e_jj = grow(self.e_jj, np.int32)
        self.e_valid = grow(self.e_valid, bool)
        self._cap = new_cap

    def _ensure_dev_capacity(self, need: int):
        if need <= self._dev_ecap:
            return
        n = self.h * self.w
        newcap = _pow2(need, lo=max(256, self._dev_ecap * 2))
        old = self._dev_edges
        new = {"idx": torch.zeros(newcap, n, dtype=torch.int32, device=self.device),
               "vm": torch.zeros(newcap, n, dtype=torch.bool, device=self.device),
               "q": torch.zeros(newcap, n, dtype=torch.float32, device=self.device)}
        for k in old:
            new[k][: self._dev_ecap] = old[k]
        self._dev_edges = new
        self._dev_ecap = newcap

    def _append_directed(self, i, j, idx, vm, q):
        """Append one directed edge (payload rows as arrays or tensors)."""
        self._ensure_capacity(1)
        self._ensure_dev_capacity(self.n_directed + 1)
        k = self.n_directed
        self.e_ii[k], self.e_jj[k], self.e_valid[k] = i, j, True
        for key, val, dt in (("idx", idx, torch.int32), ("vm", vm, torch.bool),
                             ("q", q, torch.float32)):
            self._dev_edges[key][k] = torch.as_tensor(val).to(self.device, dt)
        self.n_directed += 1

    @staticmethod
    def _edge_post(idx_i2j, idx_j2i, vm_j, vm_i, Qii, Qjj, Qji, Qij, q_conf: float):
        """Two-way match quality; only the per-edge fractions go to the host."""
        Qj = torch.sqrt(torch.gather(Qii[..., 0], 1, idx_i2j.long()) * Qji[..., 0])
        Qi = torch.sqrt(torch.gather(Qjj[..., 0], 1, idx_j2i.long()) * Qij[..., 0])
        valid_j = vm_j[..., 0] & (Qj > q_conf)
        valid_i = vm_i[..., 0] & (Qi > q_conf)
        fracs = torch.stack([valid_j.float().mean(dim=1), valid_i.float().mean(dim=1)])
        return Qj, Qi, fracs

    def add_factors(self, ii: list, jj: list, min_match_frac: float,
                    is_reloc: bool = False) -> bool:
        """Symmetric-match candidate edges; keep those whose two-way match
        fraction passes ``min_match_frac`` (consecutive pairs always pass,
        unless ``is_reloc``, where any failure rejects the lot)."""
        if not ii:
            return False
        span, dev = self.timers.span, self.device
        n_real = len(ii)
        pad_to = _pow2(n_real, lo=1)
        with span("fg.match_sym", dev):
            ii = list(ii) + [ii[-1]] * (pad_to - n_real)
            jj = list(jj) + [jj[-1]] * (pad_to - n_real)
            emb_i = [self.keyframes.get_embedding(i) for i in ii]
            emb_j = [self.keyframes.get_embedding(j) for j in jj]
            feat_i = torch.cat([e[0] for e in emb_i])
            pos_i = torch.cat([e[1] for e in emb_i])
            feat_j = torch.cat([e[0] for e in emb_j])
            pos_j = torch.cat([e[1] for e in emb_j])
            (idx_i2j, idx_j2i, vm_j, vm_i, Qii, Qjj, Qji, Qij) = self.runner.match_symmetric(
                feat_i, pos_i, feat_j, pos_j, (self.h, self.w))
        self.match_rows += 2 * pad_to
        with span("fg.fracs_pull", dev):
            Qj, Qi, fracs = self._edge_post(idx_i2j, idx_j2i, vm_j, vm_i, Qii, Qjj, Qji, Qij,
                                            float(self.cfg["Q_conf"]))
            fracs = fracs.cpu().numpy()          # (2, b): the only payload pulled
        frac_j, frac_i = fracs[0][:n_real], fracs[1][:n_real]

        ii_arr = np.asarray(ii[:n_real])
        jj_arr = np.asarray(jj[:n_real])
        invalid = np.minimum(frac_j, frac_i) < min_match_frac
        consecutive = ii_arr == (jj_arr - 1)
        invalid = (~consecutive) & invalid
        if invalid.any() and is_reloc:
            return False
        keep = ~invalid
        if not keep.any():
            return False

        with span("fg.edge_store", dev):
            kept = np.flatnonzero(keep)
            nk = kept.size
            self._ensure_capacity(2 * nk)
            self._ensure_dev_capacity(self.n_directed + 2 * nk)
            # rows [base, base+nk) hold i->j, rows [base+nk, base+2nk) hold j->i
            base = self.n_directed
            kj = torch.as_tensor(kept, device=idx_i2j.device)
            rows = slice(base, base + 2 * nk)
            self._dev_edges["idx"][rows] = torch.cat([idx_i2j[kj], idx_j2i[kj]]).to(torch.int32)
            self._dev_edges["vm"][rows] = torch.cat([vm_j[kj, :, 0], vm_i[kj, :, 0]])
            self._dev_edges["q"][rows] = torch.cat([Qj[kj], Qi[kj]])
            self.e_ii[base: base + nk] = ii_arr[kept]
            self.e_jj[base: base + nk] = jj_arr[kept]
            self.e_ii[base + nk: base + 2 * nk] = jj_arr[kept]
            self.e_jj[base + nk: base + 2 * nk] = ii_arr[kept]
            self.e_valid[base: base + 2 * nk] = True
            self.n_directed += 2 * nk
            for r in kept:
                self.ii.append(int(ii_arr[r]))
                self.jj.append(int(jj_arr[r]))
        return True

    def _solver_statics(self) -> dict:
        return dict(
            pixel_border=int(self.cfg["pixel_border"]),
            z_eps=float(self.cfg["depth_eps"]),
            sigma_pixel=float(self.cfg["sigma_pixel"]),
            sigma_depth=float(self.cfg["sigma_depth"]),
            C_thresh=float(self.cfg["C_conf"]),
            Q_thresh=float(self.cfg["Q_conf"]),
            max_iter=int(self.cfg["max_iters"]),
            delta_thresh=float(self.cfg["delta_norm"]),
            num_fix=1,
            point_stride=int(self.cfg.get("point_stride", 1)),
        )

    def solve_GN_calib(self):
        """One global GN over every keyframe an edge touches; writes back
        all poses but the pinned prefix."""
        pin = int(self.cfg["pin"])
        n_e = self.n_directed
        uniq = np.unique(np.stack([self.e_ii[:n_e], self.e_jj[:n_e]]))
        if uniq.size <= pin:
            return
        span, dev = self.timers.span, self.device
        with span("gn.prep", dev):
            remap = np.zeros(int(uniq.max()) + 1, np.int64)
            remap[uniq] = np.arange(uniq.size)

            P = _pow2(uniq.size, lo=32)
            T = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (P, 1))
            T[: uniq.size] = self.keyframes.T_WC[uniq]
            used = np.zeros(P, bool)
            used[: uniq.size] = True
            K = torch.as_tensor(self.K, device=dev)
            # pointmaps of the poses in the solve (rows past uniq.size are
            # never read: no edge references a padding pose)
            Xs = proj.constrain_points_to_ray(
                (self.h, self.w), torch.stack([self.keyframes.X_dev(int(k)) for k in uniq]), K)
            Cs = torch.stack([self.keyframes.C_dev(int(k))
                              / torch.clamp_min(self.keyframes.N_dev(int(k)), 1).float()
                              for k in uniq])

            # E: the JAX package's edge pad, bounded by the host arrays' capacity
            E = min(_pow2(n_e, lo=64), self._cap, self._dev_ecap)
            ii_p = torch.as_tensor(remap[self.e_ii[:E]], device=dev)
            jj_p = torch.as_tensor(remap[self.e_jj[:E]], device=dev)
            solver = (gauss_newton_calib if P <= self.DENSE_POSE_LIMIT
                      else gauss_newton_calib_sparse)
            if (self.mesh is not None and P <= self.DENSE_POSE_LIMIT
                    and E % self.mesh.shape[self.mesh_axis] == 0):
                solver = functools.partial(gauss_newton_calib_sharded, self.mesh,
                                           self.mesh_axis)
                self.sharded_solves += 1
        with span("gn.solve", dev):
            T_new = solver(
                torch.as_tensor(T, device=dev), Xs, Cs, K, ii_p, jj_p,
                self._dev_edges["idx"][:E], self._dev_edges["vm"][:E],
                self._dev_edges["q"][:E, :, None],
                torch.as_tensor(self.e_valid[:E], device=dev),
                torch.as_tensor(used, device=dev), self.h, self.w, **self._solver_statics())
        with span("gn.pose_pull", dev):
            T_new = T_new.cpu().numpy()
        self.solves.append((P, E, n_e))
        upd = uniq[pin:]
        self.keyframes.update_T_WCs(T_new[remap[upd]], upd)
