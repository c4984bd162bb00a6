"""Splat renders sharded by image row strips over a mesh.

Port of ``artdeco_tpu/parallel/splats.py``.  Each slot rasterizes the whole
(replicated) Gaussian set into its strip of ``H / n`` rows with the EWA
clamp of the full image (``frustum_hw``), through the single-device
rasterizer and its kernels (K1), and the strips concatenate into the full
image; the culling of each strip drops the Gaussians outside its rows.
``H`` must be a multiple of 16 n: every strip is whole 16-row tiles.

Where the JAX package shifts the principal point up by the strip's first
row and boxes footprints in the strip's tiles, the port renders the
image's rows directly (``pack_slots(strip_row0=...)``): pixel coordinates
are the image's moved up exactly, footprints boxed (and capped at 4x4
tiles) in the image's tiles, so each strip is the single render's rows.
The JAX way departs from the single render in two places: the shifted
principal point rounds a pair's alpha across the 1/255 cut here and there,
and a Gaussian wider than three tiles crossing a seam covers one tile more
there.
"""

from __future__ import annotations

import torch

from artdeco_tpu_torch.mapper.scene_model import effective_params, finish_render
from artdeco_tpu_torch.ops.splat import api as splat_api
from artdeco_tpu_torch.parallel.mesh import Mesh


def _strip_rows(mesh: Mesh, axis: str, height: int) -> tuple:
    n = mesh.shape[axis]
    if height % (16 * n):
        raise ValueError(f"height {height} must be a multiple of 16*{n}")
    return n, height // n


def _render_strips(mesh: Mesh, n: int, strip_h: int, width: int, height: int,
                   means, quats, scales, opacities, colors, viewmat, K, valid_mask,
                   **kw) -> list:
    """(render, alpha, meta) of every strip, each on its slot's device."""
    out = []
    for d in range(n):
        rep = [mesh.replicate(x, d) for x in (means, quats, scales, opacities, colors,
                                               viewmat, valid_mask)]
        out.append(splat_api.rasterization(
            *rep[:6], mesh.replicate(K, d), width, strip_h, render_mode="RGB+D",
            valid_mask=rep[6], frustum_hw=(height, width), strip_row0=d * strip_h, **kw))
    return out


def make_row_sharded_render(mesh: Mesh, width: int, height: int, sh_degree: int,
                            eps2d: float = 0.3, axis: str = "sp"):
    """A render sharded over the mesh's ``axis``.

    Returns fn(means, quats, scales, opacities, colors, viewmat, K,
    valid_mask) -> (render (H, W, 4), alpha (H, W, 1)) on the mesh's home
    device."""
    n, strip_h = _strip_rows(mesh, axis, height)

    def fn(means, quats, scales, opacities, colors, viewmat, K, valid_mask):
        strips = _render_strips(mesh, n, strip_h, width, height, means, quats, scales,
                                opacities, colors, viewmat, K, valid_mask,
                                sh_degree=sh_degree, eps2d=eps2d)
        return (torch.cat([r.to(mesh.home) for r, _, _ in strips]),
                torch.cat([a.to(mesh.home) for _, a, _ in strips]))

    return fn


def make_row_sharded_render_core(mesh: Mesh, width: int, height: int, sh_degree: int,
                                 eps2d: float, cluster_capacity: int, axis: str = "dp"):
    """A row-strip sharded render with ``render_core``'s semantics: the
    LOD fade and ``mlp_cov`` modulation (``effective_params``) before the
    strips, then the background, exposure affine, clamp and inverse depth;
    per-Gaussian visibility ORed over the strips, per-cluster visibility
    its max by cluster.

    Returns fn(slab, gfeat, mlp, viewmat, exposure, K, bg) -> dict(render
    (3, H, W), invdepth, depth, alpha (1, H, W), visibility (C,),
    global_visibility (Cg,), scale (C, 3)), on the mesh's home device."""
    n, strip_h = _strip_rows(mesh, axis, height)

    def fn(slab, gfeat, mlp, viewmat, exposure, K, bg):
        # computed once on the home device and replicated: every device of
        # the JAX package's shard_map computes these same values
        selection, opac, scale_eff, rot_eff, colors = effective_params(
            slab, gfeat, mlp, viewmat, cluster_capacity)
        strips = _render_strips(mesh, n, strip_h, width, height, slab.xyz, rot_eff,
                                scale_eff, opac, colors, viewmat, K, selection,
                                sh_degree=sh_degree, eps2d=eps2d)
        render = torch.cat([r.to(mesh.home) for r, _, _ in strips])
        alpha = torch.cat([a.to(mesh.home) for _, a, _ in strips])
        vis = mesh.pmax([torch.amax(m.radii, dim=-1) > 0 for _, _, m in strips]) & selection
        out = finish_render(render, alpha, vis, slab.cls_id, exposure, bg, cluster_capacity)
        out["scale"] = scale_eff
        return out

    return fn
