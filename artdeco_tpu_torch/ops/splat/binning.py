"""Tile binning for the splat rasterizer.

Port of ``artdeco_tpu/ops/splat/binning.py``.  Each depth-sorted Gaussian
emits up to kx*ky (tile, gaussian) pairs from its clamped tile bounding box;
one stable sort by tile id groups the pairs per tile while keeping depth
order inside each tile.  The kx x ky = 4x4-tile footprint cap is part of
the renderer's semantics (a Gaussian wider than 64 px is clipped in both
packages).

The CHUNK-aligned padded run layout of the JAX package is kept: the CUDA
compositor walks each run in CHUNK-slot batches, exactly as the Pallas
kernel walks its chunks, so the early-out decisions fall at the same slots
and the two packages can be fed the same slot matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16    # pixels per tile side
CHUNK = 128  # pair-slot alignment unit == compositor batch size


class TileBins(NamedTuple):
    """CHUNK-aligned padded tile runs (padding slots have slot_valid False)."""

    slot_gauss: torch.Tensor   # (S,) int64 gaussian index per padded slot
    slot_valid: torch.Tensor   # (S,) bool
    pad_starts: torch.Tensor   # (T,) int32 CHUNK-aligned run starts
    pad_counts: torch.Tensor   # (T,) int32 padded run lengths
    tile_counts: torch.Tensor  # (T,) int32 true pair counts
    num_pairs: torch.Tensor    # () int32 total valid pairs
    gauss_slots: torch.Tensor  # (N, kx*ky) int64 the slots of each gaussian, -1 for none


def num_slots(n: int, num_tiles: int, kx: int = 4, ky: int = 4) -> int:
    """Static slot count: every pair plus one CHUNK of padding per tile."""
    return -(-(n * kx * ky) // CHUNK) * CHUNK + num_tiles * CHUNK


@torch.no_grad()
def build_tile_bins(
    means2d: torch.Tensor,  # (N, 2) already depth-sorted
    radii: torch.Tensor,    # (N, 2) 0 marks culled
    tiles_x: int,
    tiles_y: int,
    kx: int = 4,
    ky: int = 4,
    strip_tile0: int = 0,
    image_tiles_y: Optional[int] = None,
) -> TileBins:
    """``strip_tile0`` and ``image_tiles_y``: the render is tile rows
    [strip_tile0, strip_tile0 + tiles_y) of an image of ``image_tiles_y``
    tile rows (a row strip; by default the whole image).  Footprints are
    boxed and capped in the whole image's tiles, so the strips of a sharded
    render bin each Gaussian into the tiles the whole image bins it into.
    """
    n = means2d.shape[0]
    dev = means2d.device
    num_tiles = tiles_x * tiles_y
    valid = torch.amax(radii, dim=-1) > 0
    image_tiles_y = tiles_y if image_tiles_y is None else image_tiles_y

    rx = torch.clamp_max(radii[:, 0], (kx * TILE) / 2.0)
    ry = torch.clamp_max(radii[:, 1], (ky * TILE) / 2.0)

    def tile_of(x, lo, hi):
        # NaN/inf coordinates only occur on culled rows (masked below)
        x = torch.nan_to_num(torch.floor(x / TILE), nan=0.0)
        return torch.clamp(x, lo, hi).to(torch.int32)

    # rows in the strip's tiles, clamped to the whole image's
    y_lo, y_hi = -strip_tile0, image_tiles_y - 1 - strip_tile0
    tx0 = tile_of(means2d[:, 0] - rx, 0, tiles_x - 1)
    ty0 = tile_of(means2d[:, 1] - ry, y_lo, y_hi)
    tx1 = torch.minimum(tile_of(means2d[:, 0] + rx, 0, tiles_x - 1), tx0 + kx - 1)
    ty1 = torch.minimum(tile_of(means2d[:, 1] + ry, y_lo, y_hi), ty0 + ky - 1)

    dxs = torch.arange(kx, dtype=torch.int32, device=dev)
    dys = torch.arange(ky, dtype=torch.int32, device=dev)
    txs = tx0[:, None] + dxs[None, :]                     # (N, kx)
    tys = ty0[:, None] + dys[None, :]                     # (N, ky)
    in_x = txs <= tx1[:, None]
    in_y = (tys <= ty1[:, None]) & (tys >= 0) & (tys < tiles_y)
    tile_id = tys[:, :, None] * tiles_x + txs[:, None, :]  # (N, ky, kx)
    pair_valid = valid[:, None, None] & in_y[:, :, None] & in_x[:, None, :]
    pair_tile = torch.where(
        pair_valid, tile_id, torch.full_like(tile_id, num_tiles)
    ).reshape(-1)

    # stable sort by tile id keeps depth order within each tile
    pair_tile_s, perm = torch.sort(pair_tile, stable=True)
    pair_gauss_s = perm // (kx * ky)

    tile_range = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(pair_tile_s, tile_range, side="left").to(torch.int32)
    tile_starts = bounds[:-1]
    tile_counts = bounds[1:] - bounds[:-1]
    num_pairs = bounds[-1]

    pad_counts = (-(-tile_counts // CHUNK) * CHUNK).to(torch.int32)
    pad_starts = (torch.cumsum(pad_counts, 0) - pad_counts).to(torch.int32)
    s = num_slots(n, num_tiles, kx, ky)

    # sorted pair i of tile t lands at pad_starts[t] + (i - tile_starts[t]);
    # pairs past num_pairs (invalid) go to a dummy slot S that is cut off
    t_of_pair = torch.clamp_max(pair_tile_s, num_tiles - 1).long()
    i_pair = torch.arange(pair_tile_s.shape[0], device=dev)
    dst = pad_starts[t_of_pair].long() + (i_pair - tile_starts[t_of_pair].long())
    dst = torch.where(pair_tile_s < num_tiles, dst, torch.full_like(dst, s))
    slot_gauss = torch.zeros(s + 1, dtype=torch.long, device=dev)
    slot_gauss[dst] = pair_gauss_s
    slot_valid = torch.zeros(s + 1, dtype=torch.bool, device=dev)
    slot_valid[dst] = True
    # the inverse map: pair k of gaussian g (pair index g*kx*ky + k before
    # the sort) sits in slot gauss_slots[g, k]
    gauss_slots = torch.empty_like(dst)
    gauss_slots[perm] = torch.where(dst < s, dst, torch.full_like(dst, -1))
    return TileBins(
        slot_gauss[:s], slot_valid[:s], pad_starts, pad_counts, tile_counts,
        num_pairs, gauss_slots.reshape(n, kx * ky),
    )
