"""Pointmap matching cascade: iterative ray projection + descriptor refinement.

Port of ``artdeco_tpu/ops/matching.py``:

* ``img_gradient`` / ``prep_for_iter_proj``: Scharr-like gradients of the
  ray image, normalised target points, initial projections.
* ``iter_proj``: per-pixel 2-DoF Levenberg-Marquardt with bilinear ray
  interpolation: K4 (``csrc/iter_proj.cu``) on the card, two launches a
  batch; ``iter_proj_plain``, vectorised over every pixel of a row, on the
  CPU.
* ``refine_matches``: the dilated window argmax, through K3
  (``ops/refine_dense.py``).
* ``match_iterative_proj`` / ``match`` / ``match_pi3``: the cascade.

The reference's clamping and acceptance rules are kept as the JAX package
has them: they decide which matches exist.

``iter_proj``'s data-dependent exit: the JAX package runs four head
iterations, then the remaining ones for every pixel of a row only when
more than 0.2 % of its pixels are still unconverged (the CUDA original
exits per pixel).  Both paths apply that rule, ``tail_runs``, per row: the
plain path with one host read of the converged count a row, K4 on the
device from its head's per-block counts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from artdeco_tpu_torch import kernels, trace
from artdeco_tpu_torch.ops.refine_dense import refine_matches_dense_single

EARLY_EXIT_FRAC = 0.002      # iter_proj's tail runs above this unconverged share
HEAD_ITERS = 4
_K4_THREADS = 256            # pixels a block of K4 (csrc/iter_proj.cu THREADS)


# ---------------------------------------------------------------------------
# Gradient + prep
# ---------------------------------------------------------------------------

def _scharr(p, h, w, sh):
    """(gx, gy) of a reflect-padded image through ``sh(p, dy, dx)``."""
    gx = (3.0 * (sh(p, -1, 1) - sh(p, -1, -1)) + 10.0 * (sh(p, 0, 1) - sh(p, 0, -1))
          + 3.0 * (sh(p, 1, 1) - sh(p, 1, -1))) / 32.0
    gy = (3.0 * (sh(p, 1, -1) - sh(p, -1, -1)) + 10.0 * (sh(p, 1, 0) - sh(p, -1, 0))
          + 3.0 * (sh(p, 1, 1) - sh(p, -1, 1))) / 32.0
    return gx, gy


def img_gradient(img):
    """Scharr-like x/y gradients with reflect padding.

    img: (c, h, w) or (b, c, h, w); kernel 1/32 [[-3,0,3],[-10,0,10],[-3,0,3]].
    Returns (gx, gy) of img's shape."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    h, w = img.shape[-2:]
    p = F.pad(img, (1, 1, 1, 1), mode="reflect")
    gx, gy = _scharr(p, h, w, lambda p, dy, dx: p[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    if squeeze:
        gx, gy = gx[0], gy[0]
    return gx, gy


def lin_to_pixel(idx, w: int):
    return torch.stack([idx % w, idx // w], dim=-1)


def pixel_to_lin(p, w: int):
    return p[..., 0] + w * p[..., 1]


def _unit(X):
    return X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)


def prep_for_iter_proj(X11, X21, idx_1_to_2_init):
    """X11, X21: (b, h, w, 3) pointmaps.  Returns rays_with_grad (b, h, w, 9),
    pts3d_norm (b, h*w, 3), p_init (b, h*w, 2) float."""
    b, h, w, _ = X11.shape
    rays = _unit(X11)
    p = F.pad(rays.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    gx, gy = _scharr(p, h, w, lambda p, dy, dx: p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :])
    rays_with_grad = torch.cat([rays, gx, gy], dim=-1)
    pts3d_norm = _unit(X21.reshape(b, h * w, 3))
    if idx_1_to_2_init is None:
        idx_1_to_2_init = torch.arange(h * w, device=X11.device).expand(b, h * w)
    p_init = lin_to_pixel(idx_1_to_2_init, w).to(torch.float32)
    return rays_with_grad, pts3d_norm, p_init


# ---------------------------------------------------------------------------
# iter_proj: per-pixel 2-DoF LM
# ---------------------------------------------------------------------------

def tail_runs(n_conv: int, n: int) -> bool:
    """iter_proj's tail rule: the iterations after the head run for a row
    whose unconverged share ``1 - n_conv / n``, in float32 as the JAX
    package's ``1 - mean(conv)``, exceeds ``EARLY_EXIT_FRAC``.  K4's tail
    kernel computes the same in float32 on the device."""
    one, frac = np.float32(1.0), np.float32(EARLY_EXIT_FRAC)
    return bool(one - np.float32(n_conv) / np.float32(n) > frac)


def _pack_corners(img_flat, w: int):
    """(h*w, c) -> (h*w, 4c) rows [img[i], img[i+1], img[i+w], img[i+w+1]]:
    one row gather fetches all four bilinear taps.  The rolls wrap at the
    bottom edge, but sample coordinates are clamped to [1, h-2], so wrapped
    rows are never read."""
    return torch.cat([img_flat, torch.roll(img_flat, -1, 0), torch.roll(img_flat, -w, 0),
                      torch.roll(img_flat, -w - 1, 0)], dim=-1)


def _iter_proj_single(rays_img, pts3d_norm, p_init, max_iter: int, lambda_init: float,
                      cost_thresh: float):
    h, w, _ = rays_img.shape
    packed = _pack_corners(rays_img.reshape(h * w, 9), w)        # (h*w, 36)
    pts = pts3d_norm

    def gather(u, v):
        """Corner rows and bilinear weights at (u, v).  The reference pairs
        each weight with the opposite corner.  A NaN coordinate gathers row
        0 but keeps NaN weights, so its cost is NaN and the step is
        rejected, as JAX's NaN-filled out-of-range take makes it."""
        u11, v11 = torch.floor(u), torch.floor(v)
        du, dv = u - u11, v - v11
        lin = torch.nan_to_num(v11 * w + u11, nan=0.0).long().clamp(0, h * w - 1)
        smp = packed[lin]                                         # (n, 36)
        wts = ((1.0 - du) * (1.0 - dv), du * (1.0 - dv), (1.0 - du) * dv, du * dv)
        return smp, wts

    def interp(smp, wts, lo, hi):
        # same order as the JAX package: w11 r11 + w12 r12 + w21 r21 + w22 r22
        return (wts[3][:, None] * smp[:, 27 + lo:27 + hi] + wts[2][:, None] * smp[:, 18 + lo:18 + hi]
                + wts[1][:, None] * smp[:, 9 + lo:9 + hi] + wts[0][:, None] * smp[:, lo:hi])

    def cost_at(smp, wts):
        r = interp(smp, wts, 0, 3)
        r = r / torch.sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + r[:, 2] * r[:, 2])[:, None]
        err = r - pts
        return err, err[:, 0] * err[:, 0] + err[:, 1] * err[:, 1] + err[:, 2] * err[:, 2]

    def dot3(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    def body(c):
        u, v, lam, conv, smp, wts = c
        err, cost = cost_at(smp, wts)
        gx, gy = interp(smp, wts, 3, 6), interp(smp, wts, 6, 9)
        A00 = dot3(gx, gx) + lam
        A01 = dot3(gx, gy)
        A11 = dot3(gy, gy) + lam
        b0 = -dot3(err, gx)
        b1 = -dot3(err, gy)
        det_inv = 1.0 / (A00 * A11 - A01 * A01)
        du = det_inv * (A11 * b0 - A01 * b1)
        dv = det_inv * (-A01 * b0 + A00 * b1)
        u_new = torch.clamp(u + du, 1.0, w - 2.0)
        v_new = torch.clamp(v + dv, 1.0, h - 2.0)
        smp_new, wts_new = gather(u_new, v_new)
        _, new_cost = cost_at(smp_new, wts_new)
        accept = new_cost < cost
        u = torch.where(accept, u_new, u)
        v = torch.where(accept, v_new, v)
        smp = torch.where(accept[:, None], smp_new, smp)
        wts = tuple(torch.where(accept, a, b) for a, b in zip(wts_new, wts))
        lam = torch.where(accept, lam * 0.1, lam * 10.0)
        conv = torch.where(accept, new_cost < cost_thresh, cost < cost_thresh)
        return u, v, lam, conv, smp, wts

    u0 = torch.clamp(p_init[:, 0], 1.0, w - 2.0)
    v0 = torch.clamp(p_init[:, 1], 1.0, h - 2.0)
    carry = (u0, v0, torch.full_like(u0, lambda_init),
             torch.zeros(u0.shape, dtype=torch.bool, device=u0.device), *gather(u0, v0))
    head = min(HEAD_ITERS, max_iter)
    for _ in range(head):
        carry = body(carry)
    # one host read a row
    if max_iter > head and tail_runs(int(carry[3].sum()), carry[3].numel()):
        for _ in range(head, max_iter):
            carry = body(carry)
    return torch.stack([carry[0], carry[1]], dim=-1), carry[3]


def iter_proj_plain(rays_with_grad_img, pts3d_norm, p_init, max_iter: int = 10,
                    lambda_init: float = 1e-8, cost_thresh: float = 1e-8):
    """Plain PyTorch K4: ``iter_proj`` one batch row at a time."""
    outs = [_iter_proj_single(r, p, q, max_iter, lambda_init, cost_thresh)
            for r, p, q in zip(rays_with_grad_img, pts3d_norm, p_init)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _check_iter_proj(rays, pts, p_init):
    if rays.dim() != 4 or rays.shape[-1] != 9 or pts.dim() != 3 or pts.shape[-1] != 3 \
            or p_init.shape != (*pts.shape[:2], 2) or pts.shape[0] != rays.shape[0]:
        raise ValueError(f"iter_proj: bad shapes rays {tuple(rays.shape)} pts "
                         f"{tuple(pts.shape)} p_init {tuple(p_init.shape)}")
    for name, a in (("rays", rays), ("pts", pts), ("p_init", p_init)):
        if a.dtype != torch.float32:
            raise ValueError(f"iter_proj: {name} must be float32, got {a.dtype}")
        if a.device != rays.device:
            raise ValueError(f"iter_proj: {name} is on {a.device}, rays on {rays.device}")


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter: int = 10,
              lambda_init: float = 1e-8, cost_thresh: float = 1e-8):
    """Project unit rays of frame 2 onto frame 1's ray image via per-pixel
    LM.  Inputs (b, h, w, 9), (b, n, 3), (b, n, 2) float32; returns (p_new
    float (b, n, 2), converged bool (b, n)).  Each batch row runs on its own
    and takes its own tail (``tail_runs``).

    For CUDA tensors K4 (``csrc/iter_proj.cu``): the head and the tail
    launch once each over the whole batch (counted in
    ``iter_proj.launches``; the tail only where ``max_iter`` exceeds the
    head), the rows in the tracer's ``iter_proj.rows``, with no host read.
    For CPU tensors ``iter_proj_plain``."""
    _check_iter_proj(rays_with_grad_img, pts3d_norm, p_init)
    dev = rays_with_grad_img.device
    if dev.type == "cpu":
        return iter_proj_plain(rays_with_grad_img, pts3d_norm, p_init, max_iter, lambda_init,
                               cost_thresh)
    if dev.type != "cuda":
        raise ValueError(f"iter_proj: unsupported device {dev}")
    b, h, w, _ = rays_with_grad_img.shape
    n = pts3d_norm.shape[1]
    head = max(0, min(HEAD_ITERS, max_iter))
    blocks = -(-n // _K4_THREADS)
    p_out = torch.empty((b, n, 2), dtype=torch.float32, device=dev)
    conv = torch.empty((b, n), dtype=torch.bool, device=dev)
    lam = torch.empty((b, n), dtype=torch.float32, device=dev)
    counts = torch.empty((b, blocks), dtype=torch.int32, device=dev)
    rays, pts, p0 = (a.contiguous() for a in (rays_with_grad_img, pts3d_norm, p_init))
    # the launch runs on the host thread's current device: make it the data's
    with torch.cuda.device(dev):
        err = kernels.load().artdeco_iter_proj(
            rays.data_ptr(), pts.data_ptr(), p0.data_ptr(), b, n, h, w, blocks, lambda_init,
            cost_thresh, EARLY_EXIT_FRAC, head, max_iter, p_out.data_ptr(), conv.data_ptr(),
            lam.data_ptr(), counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "iter_proj")
    if b and n:
        kernels.count_launch(_iter_proj)
        if max_iter > head:
            kernels.count_launch(_iter_proj)
    trace.count("iter_proj.rows", b)
    return p_out, conv


iter_proj.launches = 0
_iter_proj = iter_proj      # counts survive a wrapper put in the module's name


# ---------------------------------------------------------------------------
# refine_matches
# ---------------------------------------------------------------------------

def refine_matches(D11, D21, p1, radius: int = 3, dilation_max: int = 1,
                   compute_dtype=None, valid=None):
    """Coarse-to-fine local descriptor search around current matches.

    D11 (b, h, w, f), D21 (b, n, f), p1 (b, n, 2) int, valid (b, n) bool
    or None.  ``compute_dtype`` bfloat16 (the matcher's default) runs K3
    over bf16 descriptors, the queries in ``valid`` only; None runs K3's
    f32 instance on every query, as the JAX package's ``_refine_single``
    ignores ``valid``."""
    if compute_dtype in (torch.bfloat16, "bfloat16"):
        dtype = torch.bfloat16
    elif compute_dtype is None:
        dtype, valid = torch.float32, None
    else:
        raise ValueError(f"refine_matches: compute_dtype {compute_dtype!r} is neither bfloat16 "
                         "nor None")
    rows = [refine_matches_dense_single(D11[e], D21[e], p1[e], radius=radius,
                                        dilation_max=dilation_max,
                                        valid=None if valid is None else valid[e], dtype=dtype)
            for e in range(D11.shape[0])]
    return torch.stack(rows).to(p1.dtype)


# ---------------------------------------------------------------------------
# The cascade
# ---------------------------------------------------------------------------

def project_matches(X11, X21, idx_1_to_2_init, *, max_iter, lambda_init, cost_thresh,
                    dist_thresh):
    """The cascade up to refine: iter_proj, truncation to integer pixels,
    and the occlusion distance filter.  Returns (p1 (b, n, 2) int32,
    valid (b, n) bool): the positions and queries refine starts from."""
    b, h, w = X21.shape[:3]
    rays_with_grad, pts3d_norm, p_init = prep_for_iter_proj(X11, X21, idx_1_to_2_init)
    p1, valid_proj2 = iter_proj(rays_with_grad, pts3d_norm, p_init, max_iter=max_iter,
                                lambda_init=lambda_init, cost_thresh=cost_thresh)
    # truncation toward zero, as astype(int32): the coordinates are >= 1
    p1 = p1.to(torch.int32)
    # p1 lies in [1, w-2] x [1, h-2], so lin is in range
    lin = pixel_to_lin(p1, w).long()
    matched = torch.take_along_dim(X11.reshape(b, h * w, 3), lin[..., None], dim=1)
    dists2 = torch.linalg.vector_norm(matched - X21.reshape(b, h * w, 3), dim=-1)
    return p1, valid_proj2 & (dists2 < dist_thresh)


def _match_cascade(X11, X21, D11, D21, idx_1_to_2_init, *, max_iter, lambda_init,
                   cost_thresh, dist_thresh, radius, dilation_max, refine_dtype="bfloat16"):
    """iter_proj -> occlusion distance filter -> refine_matches for a batch
    of pairs.  Returns (idx_1_to_2 (b, n) int64, valid (b, n, 1) bool)."""
    b, h, w = X21.shape[:3]
    p1, valid = project_matches(X11, X21, idx_1_to_2_init, max_iter=max_iter,
                                lambda_init=lambda_init, cost_thresh=cost_thresh,
                                dist_thresh=dist_thresh)
    if D11 is not None and radius > 0:
        p1 = refine_matches(D11, D21.reshape(b, h * w, -1), p1, radius=radius,
                            dilation_max=dilation_max, compute_dtype=refine_dtype,
                            valid=valid)
    return pixel_to_lin(p1.long(), w), valid[..., None]


def match_iterative_proj(cfg: dict, X11, X21, D11, D21, idx_1_to_2_init=None):
    """iter_proj -> occlusion distance filter -> refine_matches.

    cfg: the ``matching`` config block (max_iter, lambda_init,
    convergence_thresh, dist_thresh, radius, dilation_max, optional
    refine_dtype).  Returns (idx_1_to_2 (b, n) int64, valid (b, n, 1) bool)."""
    return _match_cascade(
        X11, X21, D11, D21, idx_1_to_2_init,
        max_iter=int(cfg["max_iter"]), lambda_init=float(cfg["lambda_init"]),
        cost_thresh=float(cfg["convergence_thresh"]), dist_thresh=float(cfg["dist_thresh"]),
        radius=int(cfg["radius"]) if D11 is not None else 0,
        dilation_max=int(cfg["dilation_max"]),
        refine_dtype=cfg.get("refine_dtype", "bfloat16"))


def match(cfg, X11, X21, D11, D21, idx_1_to_2_init=None):
    """``match_iterative_proj`` as the runners call it: the tracer's
    ``match.cascade`` span."""
    with trace.span("match.cascade"):
        return match_iterative_proj(cfg, X11, X21, D11, D21, idx_1_to_2_init)


def match_pi3(cfg, X11, X21, idx_1_to_2_init=None):
    """Descriptor-free variant (the Pi3 loop-closure path).  Returns
    (idx (b, n), valid (b, n))."""
    idx, valid = match_iterative_proj(cfg, X11, X21, None, None, idx_1_to_2_init)
    return idx, valid[..., 0]
