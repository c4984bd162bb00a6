"""Pointmap matching cascade: iterative ray projection + descriptor refinement.

Port of ``artdeco_tpu/ops/matching.py``:

* ``img_gradient`` / ``prep_for_iter_proj``: Scharr-like gradients of the
  ray image, normalised target points, initial projections.
* ``iter_proj``: per-pixel 2-DoF Levenberg-Marquardt with bilinear ray
  interpolation, vectorised over every pixel.
* ``refine_matches``: the dilated window argmax, through K3
  (``ops/refine_dense.py``).
* ``match_iterative_proj`` / ``match`` / ``match_pi3``: the cascade.

The reference's clamping and acceptance rules are kept as the JAX package
has them: they decide which matches exist.

``iter_proj``'s data-dependent exit: the JAX package runs four head
iterations, then the remaining ones for every pixel only when more than
0.2 % of the pixels are still unconverged (the CUDA original exits per
pixel).  The port reproduces that rule with one host sync on the
unconverged share per call: the tail it skips costs more device time
than the sync, and the result is the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from artdeco_tpu_torch.ops.refine_dense import refine_matches_dense_single

EARLY_EXIT_FRAC = 0.002      # iter_proj's tail runs above this unconverged share
HEAD_ITERS = 4


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
# iter_proj: vectorised per-pixel 2-DoF LM
# ---------------------------------------------------------------------------

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
    if max_iter > head:
        unconv = 1.0 - carry[3].float().mean()
        if bool(unconv > EARLY_EXIT_FRAC):      # one host sync per call
            for _ in range(head, max_iter):
                carry = body(carry)
    return torch.stack([carry[0], carry[1]], dim=-1), carry[3]


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter: int = 10,
              lambda_init: float = 1e-8, cost_thresh: float = 1e-8):
    """Project unit rays of frame 2 onto frame 1's ray image via per-pixel
    LM.  Inputs (b, h, w, 9), (b, n, 3), (b, n, 2); returns (p_new float
    (b, n, 2), converged bool (b, n)).  Each batch row runs on its own."""
    outs = [_iter_proj_single(r, p, q, max_iter, lambda_init, cost_thresh)
            for r, p, q in zip(rays_with_grad_img, pts3d_norm, p_init)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


# ---------------------------------------------------------------------------
# refine_matches
# ---------------------------------------------------------------------------

def refine_matches(D11, D21, p1, radius: int = 3, dilation_max: int = 1,
                   compute_dtype=None, valid=None):
    """Coarse-to-fine local descriptor search around current matches.

    D11 (b, h, w, f), D21 (b, n, f), p1 (b, n, 2) int, valid (b, n) bool
    or None.  The bf16 search (``compute_dtype`` bfloat16, the matcher's
    default) runs through K3.  The JAX package's f32 stack path
    (``compute_dtype`` None) is not ported."""
    if compute_dtype not in (torch.bfloat16, "bfloat16"):
        raise NotImplementedError(
            "refine_matches: only the bf16 search (refine_dtype 'bfloat16') is ported; "
            "the f32 stack path of the JAX package is not")
    rows = [refine_matches_dense_single(D11[e], D21[e], p1[e], radius=radius,
                                        dilation_max=dilation_max,
                                        valid=None if valid is None else valid[e])
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
    return match_iterative_proj(cfg, X11, X21, D11, D21, idx_1_to_2_init)


def match_pi3(cfg, X11, X21, idx_1_to_2_init=None):
    """Descriptor-free variant (the Pi3 loop-closure path).  Returns
    (idx (b, n), valid (b, n))."""
    idx, valid = match_iterative_proj(cfg, X11, X21, None, None, idx_1_to_2_init)
    return idx, valid[..., 0]
