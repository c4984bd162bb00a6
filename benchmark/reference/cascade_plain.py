"""Plain matching cascade: the reference for the pointmap matches.

A frozen copy of ARTDECO's (MASt3R-SLAM's) matcher as the measured program
defines it, in plain PyTorch and imported from nowhere in the program:

1. ``iter_proj``: per pixel of frame 2, a 2-DoF Levenberg-Marquardt search
   for the pixel of frame 1 whose (bilinearly interpolated) unit ray points
   at frame 2's normalised point; four head iterations, then the rest for
   every pixel only when more than 0.2 % are still unconverged.
2. Truncation to integer pixels and the occlusion filter (matched points
   closer than ``dist_thresh``).
3. ``refine``: for each valid query, the dilated window argmax of the
   descriptor dot product (dilations ``dilation_max``..1, radius
   ``radius``), the running best kept across levels; descriptors rounded
   to bfloat16 as the configuration states (``refine_dtype``), products
   summed in float32 in channel order.

``match`` returns (idx (b, h*w) int64 into frame 1, valid (b, h*w, 1)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EARLY_EXIT_FRAC = 0.002
HEAD_ITERS = 4
FLT_MIN = 1.17549435e-38
CHUNK = 8192


def _unit(X):
    return X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)


def _scharr(p, h, w):
    def sh(dy, dx):
        return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :]
    gx = (3.0 * (sh(-1, 1) - sh(-1, -1)) + 10.0 * (sh(0, 1) - sh(0, -1))
          + 3.0 * (sh(1, 1) - sh(1, -1))) / 32.0
    gy = (3.0 * (sh(1, -1) - sh(-1, -1)) + 10.0 * (sh(1, 0) - sh(-1, 0))
          + 3.0 * (sh(1, 1) - sh(-1, 1))) / 32.0
    return gx, gy


def _iter_proj_single(rays_img, pts, p_init, max_iter, lambda_init, cost_thresh):
    h, w, _ = rays_img.shape
    flat = rays_img.reshape(h * w, 9)

    def sample(u, v):
        u11, v11 = torch.floor(u), torch.floor(v)
        du, dv = u - u11, v - v11
        lin = torch.nan_to_num(v11 * w + u11, nan=0.0).long().clamp(0, h * w - 1)
        corners = [flat[lin], flat[(lin + 1) % (h * w)], flat[(lin + w) % (h * w)],
                   flat[(lin + w + 1) % (h * w)]]
        wts = ((1.0 - du) * (1.0 - dv), du * (1.0 - dv), (1.0 - du) * dv, du * dv)
        return (wts[3][:, None] * corners[3] + wts[2][:, None] * corners[2]
                + wts[1][:, None] * corners[1] + wts[0][:, None] * corners[0])

    def cost(s):
        r = s[:, 0:3]
        r = r / torch.sqrt((r * r).sum(-1))[:, None]
        err = r - pts
        return err, (err * err).sum(-1)

    u = torch.clamp(p_init[:, 0], 1.0, w - 2.0)
    v = torch.clamp(p_init[:, 1], 1.0, h - 2.0)
    lam = torch.full_like(u, lambda_init)
    conv = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    s = sample(u, v)

    def step(u, v, lam, conv, s):
        err, c = cost(s)
        gx, gy = s[:, 3:6], s[:, 6:9]
        A00 = (gx * gx).sum(-1) + lam
        A01 = (gx * gy).sum(-1)
        A11 = (gy * gy).sum(-1) + lam
        b0, b1 = -(err * gx).sum(-1), -(err * gy).sum(-1)
        det_inv = 1.0 / (A00 * A11 - A01 * A01)
        u_new = torch.clamp(u + det_inv * (A11 * b0 - A01 * b1), 1.0, w - 2.0)
        v_new = torch.clamp(v + det_inv * (-A01 * b0 + A00 * b1), 1.0, h - 2.0)
        s_new = sample(u_new, v_new)
        _, c_new = cost(s_new)
        acc = c_new < c
        return (torch.where(acc, u_new, u), torch.where(acc, v_new, v),
                torch.where(acc, lam * 0.1, lam * 10.0),
                torch.where(acc, c_new < cost_thresh, c < cost_thresh),
                torch.where(acc[:, None], s_new, s))

    head = min(HEAD_ITERS, max_iter)
    for _ in range(head):
        u, v, lam, conv, s = step(u, v, lam, conv, s)
    if max_iter > head and float(1.0 - conv.float().mean()) > EARLY_EXIT_FRAC:
        for _ in range(head, max_iter):
            u, v, lam, conv, s = step(u, v, lam, conv, s)
    return torch.stack([u, v], dim=-1), conv


def _refine_single(D11, D21, p, valid, radius, d_max):
    """Per valid query the dilated window argmax; bf16 descriptors, f32 sums."""
    h, w, f = D11.shape
    dev = D11.device
    D11 = D11.to(torch.bfloat16).float()
    D21 = D21.to(torch.bfloat16).float()
    span = 2 * radius + 1
    u, v = p[:, 0].clone(), p[:, 1].clone()
    best = torch.full((p.shape[0],), FLT_MIN, dtype=torch.float32, device=dev)
    act = torch.nonzero(valid).flatten()
    off = torch.arange(span, device=dev)
    for d in range(d_max, 0, -1):
        rd = radius * d
        Hp, Wp = h + 2 * rd, w + 2 * rd
        P = F.pad(D11.permute(2, 0, 1), (rd, rd, rd, rd)).reshape(f, Hp * Wp)
        for c0 in range(0, act.numel(), CHUNK):
            ids = act[c0:c0 + CHUNK]
            uq, vq = u[ids], v[ids]
            rows = (vq[:, None, None] + off[None, None, :] * d).clamp(0, Hp - 1)
            cols = (uq[:, None, None] + off[None, :, None] * d).clamp(0, Wp - 1)
            lin = (rows * Wp + cols).reshape(-1).long()
            g = D21[ids].T
            sc = torch.zeros(len(ids), span * span, dtype=torch.float32, device=dev)
            for c in range(f):
                sc.add_(P[c][lin].view_as(sc) * g[c][:, None])
            bs, bo = torch.max(sc, dim=1)
            upd = bs > best[ids]
            best[ids] = torch.where(upd, bs, best[ids])
            u[ids] = torch.where(upd, uq - rd + (bo // span) * d, uq)
            v[ids] = torch.where(upd, vq - rd + (bo % span) * d, vq)
    return torch.stack([u, v], dim=-1)


def match(cfg: dict, X11, X21, D11, D21, idx_init=None):
    """X11, X21 (b, h, w, 3) pointmaps, D11, D21 (b, h, w, f) descriptors,
    idx_init (b, h*w) or None; ``cfg`` the configuration's ``matching``
    block."""
    b, h, w, _ = X11.shape
    rays = _unit(X11)
    p = F.pad(rays.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    gx, gy = _scharr(p, h, w)
    rays_g = torch.cat([rays, gx, gy], dim=-1)
    pts = _unit(X21.reshape(b, h * w, 3))
    if idx_init is None:
        idx_init = torch.arange(h * w, device=X11.device).expand(b, h * w)
    p_init = torch.stack([idx_init % w, idx_init // w], dim=-1).float()
    idxs, valids = [], []
    for e in range(b):
        pe, conv = _iter_proj_single(rays_g[e], pts[e], p_init[e], int(cfg["max_iter"]),
                                     float(cfg["lambda_init"]), float(cfg["convergence_thresh"]))
        pe = pe.to(torch.int64)
        lin = pe[:, 0] + w * pe[:, 1]
        dist = torch.linalg.vector_norm(X11[e].reshape(h * w, 3)[lin]
                                        - X21[e].reshape(h * w, 3), dim=-1)
        valid = conv & (dist < float(cfg["dist_thresh"]))
        if int(cfg["radius"]) > 0:
            pe = _refine_single(D11[e], D21[e].reshape(h * w, -1), pe, valid,
                                int(cfg["radius"]), int(cfg["dilation_max"]))
        idxs.append(pe[:, 0] + w * pe[:, 1])
        valids.append(valid)
    return torch.stack(idxs), torch.stack(valids)[..., None]
