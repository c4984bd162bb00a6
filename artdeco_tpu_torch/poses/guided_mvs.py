"""Guided multi-view depth from sparse matches.

Port of ``artdeco_tpu/poses/guided_mvs.py``: for each keypoint matched in
another view, the depth along the current ray that best explains the
matched pixel (closed-form two-view least squares); per keypoint the
smallest residual over the candidate views is kept.
"""

from __future__ import annotations

import torch


def uv_to_depth(uv, uv_other, R, t, f, centre):
    """Depth d such that proj(R (d ray(uv)) + t) ~= uv_other, by least
    squares over the two pixel equations; (R, t) = other <- current.
    Returns (depth (P,), residual (P,))."""
    ray = torch.cat([(uv - centre) / f, torch.ones_like(uv[:, :1])], dim=1)
    rc = ray @ R.T
    xo = (uv_other - centre) / f
    # d (rc_xy - xo rc_z) = xo t_z - t_xy: two equations, one unknown
    a = rc[:, :2] - xo * rc[:, 2:3]
    b = xo * t[2] - t[:2][None, :]
    denom = torch.sum(a * a, dim=1)
    d = torch.sum(a * b, dim=1) / torch.clamp(denom, min=1e-12)
    resid = torch.linalg.vector_norm(a * d[:, None] - b, dim=1)
    return d, resid


def guided_depth(uv, uvs_others, Rt, Rts_others, f, centre, max_resid: float = 5e-3):
    """The smallest-residual depth per keypoint across the candidate views
    (uvs_others (K, P, 2), -1 marks a missing match).  Returns (depth (P,),
    valid (P,))."""
    depth = torch.zeros(uv.shape[0], dtype=uv.dtype, device=uv.device)
    best_res = torch.full((uv.shape[0],), torch.inf, dtype=uv.dtype, device=uv.device)
    for k in range(uvs_others.shape[0]):
        rel = Rts_others[k] @ torch.linalg.inv(Rt)      # other <- current
        d, res = uv_to_depth(uv, uvs_others[k], rel[:3, :3], rel[:3, 3], f, centre)
        ok = ((d > 1e-6) & (res < best_res) & (res < max_resid)
              & (uvs_others[k].min(dim=-1).values > 0))
        depth = torch.where(ok, d, depth)
        best_res = torch.where(ok, res, best_res)
    return depth, depth > 0
