"""N-view triangulation keeping the largest-disparity candidate per point.

Port of ``artdeco_tpu/poses/triangulator.py``: the two-view midpoint of
each keypoint against each of K candidate frames; per point the
triangulation with the largest disparity whose reprojection error passes
``max_error`` is kept.  The JAX package's ``lax.scan`` over the views is a
loop here.
"""

from __future__ import annotations

import torch


def matches_to_points(uv, uv_other, R, t, f, centre):
    """Two-view midpoint triangulation in the current camera frame.

    uv, uv_other (P, 2); (R, t) = relative transform current <- other.
    Returns (points (P, 3) in the current camera, disparity (P,),
    reprojection error (P,) over f)."""
    ones = torch.ones_like(uv[:, :1])
    d1 = torch.cat([(uv - centre) / f, ones], dim=1)
    d2 = torch.cat([(uv_other - centre) / f, ones], dim=1) @ R.T
    o2 = t
    # closest points of the rays o1 + a d1 and o2 + b d2
    d11 = torch.sum(d1 * d1, dim=1)
    d22 = torch.sum(d2 * d2, dim=1)
    d12 = torch.sum(d1 * d2, dim=1)
    den = torch.clamp(d11 * d22 - d12 * d12, min=1e-12)
    r = o2[None, :]
    r1 = torch.sum(r * d1, dim=1)
    r2 = torch.sum(r * d2, dim=1)
    a = (r1 * d22 - r2 * d12) / den
    b = (r1 * d12 - r2 * d11) / den
    pts = 0.5 * (a[:, None] * d1 + (o2[None, :] + b[:, None] * d2))
    # disparity: the angular separation of the rays
    cos = d12 / torch.sqrt(torch.clamp(d11 * d22, min=1e-12))
    disparity = 1.0 - torch.clamp(cos, -1.0, 1.0)
    z = torch.clamp(pts[:, 2:3], min=1e-9)
    uv_hat = f * pts[:, :2] / z + centre
    err = torch.linalg.vector_norm(uv_hat - uv, dim=1) / f
    return pts, disparity, err


def triangulate(uv, uvs_others, Rt, Rts_others, f, centre, max_error: float, min_dis: float):
    """uv (P, 2) current keypoints, uvs_others (K, P, 2) with -1 for a
    missing match, Rt (4, 4) current world -> cam, Rts_others (K, 4, 4).
    Returns (world points (P, 3), depth (P,), disparity (P,), valid (P,))."""
    kpts3d = torch.zeros(uv.shape[0], 3, dtype=uv.dtype, device=uv.device)
    best_dis = torch.zeros(uv.shape[0], dtype=uv.dtype, device=uv.device)
    for k in range(uvs_others.shape[0]):
        rel = Rt @ torch.linalg.inv(Rts_others[k])
        pts, dis, err = matches_to_points(uv, uvs_others[k], rel[:3, :3], rel[:3, 3], f, centre)
        ok = ((pts[:, 2] > 1e-6) & (dis > best_dis) & (err < max_error)
              & (uvs_others[k].min(dim=-1).values > 0))
        kpts3d = torch.where(ok[:, None], pts, kpts3d)
        best_dis = torch.where(ok, dis, best_dis)
    depth = kpts3d[:, 2]
    world = (kpts3d - Rt[:3, 3]) @ Rt[:3, :3]
    return world, depth, best_dis, best_dis > min_dis
