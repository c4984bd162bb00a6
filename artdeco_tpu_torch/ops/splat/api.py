"""gsplat-compatible rasterization API (the surface the scene model uses).

Port of ``artdeco_tpu/ops/splat/api.py``: project (torch autograd) -> SH
colors -> stable depth sort -> tile binning -> tile compositing (K1/K2
behind a ``torch.autograd.Function``).  The slot gather is a
``torch.autograd.Function`` too: its backward sums each Gaussian's slot
gradients back onto it, as JAX's gather-VJP does, but in a fixed order
through the per-Gaussian slot table of the binning, so it is
deterministic and needs no atomics.

The JAX package's ``compact_budget`` (visible-set compaction before the
sort) is left out: it only changes cost, and the image is identical
whenever the budget covers the visible set.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from artdeco_tpu_torch.ops.splat import binning, composite, project, sh
from artdeco_tpu_torch.ops.splat.binning import TILE


class SlotGather(torch.autograd.Function):
    """slot_data[:, s] = packed[slot_gauss[s]] where slot_valid[s], else 0.

    Backward: each Gaussian sums the gradients of its at most kx*ky slots,
    read through ``gauss_slots`` (N, kx*ky; -1 for none) in slot-table
    order.  A scatter-add over ``slot_gauss`` instead would add atomically
    in no fixed order, making the mapper's training nondeterministic on the
    card, and would add a zero for every padding slot into row 0."""

    @staticmethod
    def forward(ctx, packed, slot_gauss, slot_valid, gauss_slots):
        ctx.save_for_backward(gauss_slots)
        ctx.n_slots = slot_gauss.shape[0]
        gathered = packed.index_select(0, slot_gauss)
        return torch.where(slot_valid[:, None], gathered, torch.zeros_like(gathered)).T

    @staticmethod
    def backward(ctx, g):  # g: (16, S)
        (gauss_slots,) = ctx.saved_tensors
        n, k = gauss_slots.shape
        # row S is the zero row that absent pairs (-1) read
        rows = torch.cat([g.T, g.new_zeros(1, g.shape[0])])
        idx = torch.where(gauss_slots >= 0, gauss_slots,
                          torch.full_like(gauss_slots, ctx.n_slots))
        per_pair = rows.index_select(0, idx.reshape(-1)).reshape(n, k, g.shape[0])
        return per_pair.sum(1), None, None, None


class RasterMeta(NamedTuple):
    radii: torch.Tensor      # (N, 2), zeroed where valid_mask is False
    means2d: torch.Tensor    # (N, 2)
    depths: torch.Tensor     # (N,)
    num_pairs: torch.Tensor  # () binning occupancy


class PackedSlots(NamedTuple):
    """The compositor's input: depth-sorted (tile, Gaussian) slots."""

    slot_data: torch.Tensor   # (16, S) transposed packed slots
    pad_starts: torch.Tensor  # (T,) int32 CHUNK-aligned run starts
    pad_counts: torch.Tensor  # (T,) int32 padded run lengths
    width: int
    height: int
    n_ch: int                 # composited channels
    meta: RasterMeta

    @property
    def tiles_x(self) -> int:
        return -(-self.width // TILE)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // TILE)


def pack_slots(
    means: torch.Tensor,       # (N, 3)
    quats: torch.Tensor,       # (N, 4) wxyz
    scales: torch.Tensor,      # (N, 3)
    opacities: torch.Tensor,   # (N,)
    colors: torch.Tensor,      # (N, K, 3) SH coeffs, or (N, 3) if sh_degree is None
    viewmat: torch.Tensor,     # (4, 4) world->cam
    K: torch.Tensor,           # (3, 3)
    width: int,
    height: int,
    sh_degree: Optional[int] = None,
    render_mode: str = "RGB+D",
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    antialiased: bool = False,
    kx: int = 4,
    ky: int = 4,
    valid_mask: Optional[torch.Tensor] = None,
    frustum_hw: Optional[tuple] = None,
    strip_row0: int = 0,
) -> PackedSlots:
    """Everything before the compositor: project, SH colors, stable depth
    sort, tile binning and the slot gather (differentiable).

    A row strip of a larger image: rows [strip_row0, strip_row0 + height)
    (``strip_row0`` a multiple of 16) of the image ``K`` sees, whose
    (H, W) is ``frustum_hw``; it sets the EWA Jacobian's clamp, and
    footprints are boxed in its tiles (``project.project_gaussians``,
    ``binning.build_tile_bins``), so a strip renders the image's rows."""
    if strip_row0 % TILE:
        raise ValueError(f"strip_row0 {strip_row0} is not a multiple of {TILE}")
    n = means.shape[0]
    proj = project.project_gaussians(
        means, quats, scales, viewmat, K, width, height,
        eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
        antialiased=antialiased, radius_clip=radius_clip, frustum_hw=frustum_hw,
        row0=strip_row0,
    )
    radii = proj.radii
    if valid_mask is not None:
        # external culling (active/LOD masks): zeroed radii drop the
        # Gaussian from binning entirely
        radii = torch.where(valid_mask[:, None], radii, torch.zeros_like(radii))

    cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    opac = opacities * proj.compensations
    if sh_degree is not None:
        rgb = sh.sh_to_color(sh_degree, means - cam_pos, colors)
    else:
        rgb = colors
    with_depth = render_mode.endswith("+D")
    channels = torch.cat([rgb, proj.depths[:, None]], dim=-1) if with_depth else rgb
    n_ch = channels.shape[-1]
    if n_ch > composite.C_MAX - 1:
        raise ValueError(f"at most {composite.C_MAX - 1} channels, got {n_ch}")

    # depth sort front to back; stable, as jnp.argsort is (ties keep index
    # order, which fixes the compositing order of equal-depth Gaussians)
    order = torch.argsort(proj.depths.detach(), stable=True)
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    bins = binning.build_tile_bins(
        proj.means2d.detach()[order], radii.detach()[order], tiles_x, tiles_y, kx, ky,
        strip_row0 // TILE, -(-frustum_hw[0] // TILE) if frustum_hw else None,
    )
    # binning indexes Gaussians in depth order: map both tables back to the
    # caller's order, so the gather reads the unsorted rows directly
    slot_gauss = order[bins.slot_gauss]
    gauss_slots = torch.empty_like(bins.gauss_slots)
    gauss_slots[order] = bins.gauss_slots

    packed = torch.cat(
        [
            proj.means2d,
            proj.conics,
            opac[:, None],
            means.new_zeros(n, 2),
            channels,
            means.new_zeros(n, composite.C_MAX - n_ch),
        ],
        dim=-1,
    )  # (N, 16)
    # gather into CHUNK-aligned padded slots, transposed (16, S); padding
    # slots are zero and composite to nothing
    slot_data = SlotGather.apply(packed, slot_gauss, bins.slot_valid, gauss_slots)
    meta = RasterMeta(radii=radii, means2d=proj.means2d, depths=proj.depths,
                      num_pairs=bins.num_pairs)
    return PackedSlots(slot_data, bins.pad_starts, bins.pad_counts, width, height,
                       n_ch, meta)


def rasterization(*args, **kwargs):
    """Returns (render (H, W, C), alpha (H, W, 1), meta); the arguments are
    ``pack_slots``'.  render_mode "RGB" -> C=3; "RGB+D" -> C=4 with expected
    depth in [..., 3]."""
    p = pack_slots(*args, **kwargs)
    out = composite.tile_composite(
        p.slot_data, p.pad_starts, p.pad_counts, p.tiles_x, p.tiles_y
    )  # (T, 256, 8)
    img = (
        out.reshape(p.tiles_y, p.tiles_x, TILE, TILE, composite.C_MAX)
        .permute(0, 2, 1, 3, 4)
        .reshape(p.tiles_y * TILE, p.tiles_x * TILE, composite.C_MAX)
    )[:p.height, :p.width]
    render = img[..., :p.n_ch]
    alpha = img[..., composite.C_MAX - 1:composite.C_MAX]
    return render, alpha, p.meta
