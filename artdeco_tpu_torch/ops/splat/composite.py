"""Tile-based alpha compositing for 3D Gaussian splatting.

Port of ``artdeco_tpu/ops/splat/composite.py``.  The two Pallas TPU kernels
become hand-written CUDA kernels for Hopper (``csrc/composite.cu``):

* K1 ``composite_fwd`` replaces ``_fwd_kernel`` (``tile_composite`` /
  ``_fwd_impl``): front-to-back compositing of each 16x16 tile's
  depth-sorted slots, one block per tile, one thread per pixel, with the
  tile-wide early-out voted once per 128-slot chunk.
* K2 ``composite_bwd`` replaces ``_bwd_kernel`` (``_bwd_rule``): the
  two-pass recompute backward, each slot's gradients reduced over the tile's
  pixels inside the block (no atomics; deterministic).

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``.launches``; it runs the plain PyTorch version beside it only for CPU
tensors.  The plain versions (vectorised over tiles, looping over 128-slot
chunks with the same early-out rule) are the reference the CUDA kernels
are compared with on the card.

Slot matrix layout (16, S), as in the JAX package:
  [0] mean_x  [1] mean_y  [2] conic_a  [3] conic_b  [4] conic_c
  [5] opacity [6..7] pad  [8..15] channels (e.g. r, g, b, depth)
"""

from __future__ import annotations

import torch

from artdeco_tpu_torch import kernels

TILE = 16
PIX = TILE * TILE          # 256 pixels per tile
CHUNK = 128                # slots per early-out step == slot alignment
D_PAIR = 16                # packed slot rows
C_MAX = 8                  # output channel slots (colors + alpha)
ALPHA_CLAMP = 0.999
ALPHA_MIN = 1.0 / 255.0
LOG_EPS = -9.21034         # log(1e-4): transmittance early-out


def _pix_coords(num_tiles: int, tiles_x: int, device) -> tuple:
    """Pixel-centre coordinates, each (T, PIX, 1)."""
    t = torch.arange(num_tiles, device=device)[:, None]
    lin = torch.arange(PIX, device=device)[None, :]
    px = ((t % tiles_x) * TILE + lin % TILE).float() + 0.5
    py = ((t // tiles_x) * TILE + lin // TILE).float() + 0.5
    return px[..., None], py[..., None]


def _chunk_alpha(d, px, py):
    """Alpha and d(alpha)/d(opacity), each (T, PIX, CHUNK), for a chunk
    d (16, T, CHUNK).  gsplat rules: sigma >= 0, alpha >= 1/255, clamp at
    0.999 (clamped pairs keep the value but drop the opacity gradient)."""
    mx, my = d[0][:, None, :], d[1][:, None, :]
    ca, cb, cc = d[2][:, None, :], d[3][:, None, :], d[4][:, None, :]
    op = d[5][:, None, :]
    dx = px - mx
    dy = py - my
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    ex = torch.exp(-sigma)
    raw = op * ex
    value_valid = (sigma >= 0.0) & (raw >= ALPHA_MIN)
    grad_valid = value_valid & (raw <= ALPHA_CLAMP)
    zero = torch.zeros_like(raw)
    alpha = torch.where(value_valid, torch.clamp_max(raw, ALPHA_CLAMP), zero)
    e = torch.where(grad_valid, ex, zero)
    return alpha, e, dx, dy


def _gather_chunk(slot_data, pad_starts, ci, live):
    """Chunk ci of every tile's run as (16, T, CHUNK); tiles that are not
    live read column 0 (their results are masked by the caller)."""
    lane = torch.arange(CHUNK, device=slot_data.device)
    idx = (pad_starts.long() + ci * CHUNK)[:, None] + lane[None, :]
    idx = torch.where(live[:, None], idx, torch.zeros_like(idx))
    return slot_data[:, idx], idx


def _check_inputs(slot_data, pad_starts, pad_counts, tiles_x, tiles_y):
    num_tiles = tiles_x * tiles_y
    if slot_data.dtype != torch.float32 or slot_data.dim() != 2 \
            or slot_data.shape[0] != D_PAIR:
        raise ValueError(f"slot_data must be (16, S) float32, got "
                         f"{tuple(slot_data.shape)} {slot_data.dtype}")
    for name, a in (("pad_starts", pad_starts), ("pad_counts", pad_counts)):
        if a.dtype != torch.int32 or a.shape != (num_tiles,):
            raise ValueError(f"{name} must be ({num_tiles},) int32")
        if a.device != slot_data.device:
            raise ValueError(f"{name} is on {a.device}, slot_data on "
                             f"{slot_data.device}")


# ---------------------------------------------------------------------------
# K1: forward
# ---------------------------------------------------------------------------

def composite_fwd_plain(slot_data, pad_starts, pad_counts, tiles_x, tiles_y):
    """Plain PyTorch K1: (16, S) slots -> (T, PIX, 8) tile images."""
    num_tiles = tiles_x * tiles_y
    dev = slot_data.device
    px, py = _pix_coords(num_tiles, tiles_x, dev)
    nchunks = pad_counts.long() // CHUNK
    carry = torch.zeros(num_tiles, PIX, 1, device=dev)      # log T
    accum = torch.zeros(num_tiles, PIX, C_MAX, device=dev)
    max_chunks = int(nchunks.max()) if num_tiles else 0
    for ci in range(max_chunks):
        live = (ci < nchunks) & (torch.amax(carry, dim=(1, 2)) > LOG_EPS)
        if not bool(live.any()):
            break
        d, _ = _gather_chunk(slot_data, pad_starts, ci, live)
        alpha, _, _, _ = _chunk_alpha(d, px, py)
        alpha = alpha * live[:, None, None]
        s = torch.log1p(-alpha)
        cum_excl = torch.cumsum(s, dim=-1) - s + carry
        w = alpha * torch.exp(cum_excl)
        colors = d[8:8 + C_MAX].permute(1, 2, 0)             # (T, CHUNK, 8)
        accum = accum + w @ colors
        carry = carry + torch.sum(s, dim=-1, keepdim=True)
    alpha_img = 1.0 - torch.exp(carry)
    return torch.cat([accum[..., :C_MAX - 1], alpha_img], dim=-1)


def composite_fwd(slot_data, pad_starts, pad_counts, tiles_x, tiles_y):
    """K1: launches the CUDA kernel for CUDA tensors (counted in
    ``composite_fwd.launches``); the plain version for CPU tensors.

    Replaces the Pallas ``_fwd_kernel`` (``artdeco_tpu/ops/splat/
    composite.py``).  On the H100 it is bound by each pixel's exp and FMAs
    per slot, not by memory: a 128-slot batch (8 KB) is staged in shared
    memory once and read by all 256 pixels of the tile."""
    _check_inputs(slot_data, pad_starts, pad_counts, tiles_x, tiles_y)
    if slot_data.device.type == "cpu":
        return composite_fwd_plain(slot_data, pad_starts, pad_counts,
                                   tiles_x, tiles_y)
    if slot_data.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {slot_data.device}")
    num_tiles = tiles_x * tiles_y
    slot_data = slot_data.contiguous()
    out = torch.empty(num_tiles, PIX, C_MAX, device=slot_data.device)
    lib = kernels.load()
    err = lib.artdeco_composite_fwd(
        slot_data.data_ptr(), slot_data.shape[1], pad_starts.data_ptr(),
        pad_counts.data_ptr(), num_tiles, tiles_x, out.data_ptr(),
        torch.cuda.current_stream(slot_data.device).cuda_stream,
    )
    kernels.check(err, "composite_fwd")
    composite_fwd.launches += 1
    return out


composite_fwd.launches = 0


# ---------------------------------------------------------------------------
# K2: backward
# ---------------------------------------------------------------------------

def composite_bwd_plain(slot_data, pad_starts, pad_counts, tiles_x, tiles_y,
                        g_out):
    """Plain PyTorch K2: d loss / d slot_data (16, S); slots outside every
    tile run get 0."""
    num_tiles = tiles_x * tiles_y
    dev = slot_data.device
    S = slot_data.shape[1]
    px, py = _pix_coords(num_tiles, tiles_x, dev)
    nchunks = pad_counts.long() // CHUNK
    g_alpha = g_out[..., C_MAX - 1:C_MAX]                    # (T, PIX, 1)
    g_c = torch.cat([g_out[..., :C_MAX - 1],
                     torch.zeros_like(g_alpha)], dim=-1)     # (T, PIX, 8)
    max_chunks = int(nchunks.max()) if num_tiles else 0
    zeros = torch.zeros(num_tiles, PIX, 1, device=dev)

    # pass A: total weighted-gradient mass + final transmittance
    carry, total_q = zeros, zeros
    for ci in range(max_chunks):
        live = (ci < nchunks) & (torch.amax(carry, dim=(1, 2)) > LOG_EPS)
        if not bool(live.any()):
            break
        d, _ = _gather_chunk(slot_data, pad_starts, ci, live)
        alpha, _, _, _ = _chunk_alpha(d, px, py)
        alpha = alpha * live[:, None, None]
        s = torch.log1p(-alpha)
        w = alpha * torch.exp(torch.cumsum(s, dim=-1) - s + carry)
        cg = g_c @ d[8:8 + C_MAX].permute(1, 0, 2)           # (T, PIX, CHUNK)
        total_q = total_q + torch.sum(w * cg, dim=-1, keepdim=True)
        carry = carry + torch.sum(s, dim=-1, keepdim=True)
    galpha_T = g_alpha * torch.exp(carry)

    # pass B: per-slot gradients over every chunk (no early-out)
    grad = torch.zeros(D_PAIR, S + 1, device=dev)            # col S: dummy
    carry, pref_q = zeros, zeros
    for ci in range(max_chunks):
        has = ci < nchunks
        d, idx = _gather_chunk(slot_data, pad_starts, ci, has)
        alpha, e, dx, dy = _chunk_alpha(d, px, py)
        alpha = alpha * has[:, None, None]
        e = e * has[:, None, None]
        s = torch.log1p(-alpha)
        Tj = torch.exp(torch.cumsum(s, dim=-1) - s + carry)
        w = alpha * Tj
        cg = g_c @ d[8:8 + C_MAX].permute(1, 0, 2)
        q = w * cg
        suffix = total_q - (torch.cumsum(q, dim=-1) + pref_q)
        dl_da = cg * Tj + (galpha_T - suffix) / (1.0 - alpha)
        ca, cb, cc = d[2][:, None, :], d[3][:, None, :], d[4][:, None, :]
        g_sigma = -dl_da * alpha
        rows = [
            g_sigma * -(ca * dx + cb * dy),
            g_sigma * -(cc * dy + cb * dx),
            g_sigma * 0.5 * dx * dx,
            g_sigma * dx * dy,
            g_sigma * 0.5 * dy * dy,
            dl_da * e,
        ]
        g_slot = torch.stack([r.sum(dim=1) for r in rows], dim=0)  # (6, T, C)
        g_col = (w.transpose(1, 2) @ g_c).permute(2, 0, 1)         # (8, T, C)
        pad = torch.zeros(2, num_tiles, CHUNK, device=dev)
        g_all = torch.cat([g_slot, pad, g_col], dim=0)             # (16, T, C)
        dst = torch.where(has[:, None], idx, torch.full_like(idx, S))
        grad[:, dst.reshape(-1)] = g_all.reshape(D_PAIR, -1)
        pref_q = pref_q + torch.sum(q, dim=-1, keepdim=True)
        carry = carry + torch.sum(s, dim=-1, keepdim=True)
    return grad[:, :S]


def composite_bwd(slot_data, pad_starts, pad_counts, tiles_x, tiles_y, g_out):
    """K2: launches the CUDA kernel for CUDA tensors (counted in
    ``composite_bwd.launches``); the plain version for CPU tensors.

    Replaces the Pallas ``_bwd_kernel`` (``artdeco_tpu/ops/splat/
    composite.py``).  On the H100 it is bound by the per-slot reduction of
    13 gradients over 256 pixels; the kernel does it with warp shuffles and
    one fixed-order pass over the 8 warps in shared memory, and writes each
    slot once (a slot belongs to one tile), so it needs no global atomics."""
    _check_inputs(slot_data, pad_starts, pad_counts, tiles_x, tiles_y)
    num_tiles = tiles_x * tiles_y
    if g_out.shape != (num_tiles, PIX, C_MAX) or g_out.dtype != torch.float32:
        raise ValueError(f"g_out must be ({num_tiles}, {PIX}, {C_MAX}) float32")
    if slot_data.device.type == "cpu":
        return composite_bwd_plain(slot_data, pad_starts, pad_counts,
                                   tiles_x, tiles_y, g_out)
    if slot_data.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {slot_data.device}")
    slot_data = slot_data.contiguous()
    g_out = g_out.contiguous()
    # zeros: slots outside every run are never written by the kernel
    grad = torch.zeros_like(slot_data)
    lib = kernels.load()
    err = lib.artdeco_composite_bwd(
        slot_data.data_ptr(), slot_data.shape[1], pad_starts.data_ptr(),
        pad_counts.data_ptr(), num_tiles, tiles_x, g_out.data_ptr(),
        grad.data_ptr(),
        torch.cuda.current_stream(slot_data.device).cuda_stream,
    )
    kernels.check(err, "composite_bwd")
    composite_bwd.launches += 1
    return grad


composite_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _TileComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slot_data, pad_starts, pad_counts, tiles_x, tiles_y):
        ctx.save_for_backward(slot_data, pad_starts, pad_counts)
        ctx.tiles = (tiles_x, tiles_y)
        return composite_fwd(slot_data, pad_starts, pad_counts, tiles_x, tiles_y)

    @staticmethod
    def backward(ctx, g_out):
        slot_data, pad_starts, pad_counts = ctx.saved_tensors
        g = composite_bwd(slot_data, pad_starts, pad_counts, *ctx.tiles,
                          g_out.contiguous())
        return g, None, None, None, None


def tile_composite(slot_data, pad_starts, pad_counts, tiles_x: int, tiles_y: int):
    """Composite packed slots (16, S) into per-tile images (T, PIX, 8):
    channels 0..6 composited, slot 7 = alpha.  Differentiable in
    ``slot_data`` through K2."""
    return _TileComposite.apply(slot_data, pad_starts, pad_counts, tiles_x, tiles_y)


# ---------------------------------------------------------------------------
# Plain full-image reference compositor (golden tests; O(N * H * W))
# ---------------------------------------------------------------------------

def composite_reference(means2d, conics, opacities, channels, width, height):
    """Depth-ordered full-image compositing with the same alpha rules.

    Inputs must be depth-sorted front to back.  Returns (H, W, C) and
    alpha (H, W)."""
    dev = means2d.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    px = xs.reshape(-1)[:, None]
    py = ys.reshape(-1)[:, None]
    dx = px - means2d[None, :, 0]
    dy = py - means2d[None, :, 1]
    ca, cb, cc = conics[:, 0], conics[:, 1], conics[:, 2]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    raw = opacities[None, :] * torch.exp(-sigma)
    valid = (sigma >= 0.0) & (raw >= ALPHA_MIN)
    alpha = torch.where(valid, torch.clamp_max(raw, ALPHA_CLAMP), torch.zeros_like(raw))
    s = torch.log1p(-alpha)
    cum_excl = torch.cumsum(s, dim=1) - s
    w = alpha * torch.exp(cum_excl)
    img = w @ channels
    alpha_img = 1.0 - torch.exp(torch.sum(s, dim=1))
    c = channels.shape[1]
    return img.reshape(height, width, c), alpha_img.reshape(height, width)
