"""Tile-based alpha compositing for 3D Gaussian splatting.

Port of ``artdeco_tpu/ops/splat/composite.py``.  The two Pallas TPU kernels
become hand-written CUDA kernels for Hopper (``csrc/composite.cu``):

* K1 ``composite_fwd`` replaces ``_fwd_kernel`` (``tile_composite`` /
  ``_fwd_impl``): front-to-back compositing of each 16x16 tile's
  depth-sorted slots, a cluster of four blocks per tile, each chunk's walk
  split into four sub-runs whose (transmittance, colour) pairs are combined
  in order, with the tile-wide early-out voted once per 128-slot chunk.  It
  also returns each tile's stop chunk (the number of chunks it composited).
* K2 ``composite_bwd`` replaces ``_bwd_kernel`` (``_bwd_rule``): the
  recompute backward, split at chunk boundaries into per-chunk summaries,
  a scan per tile into checkpoints, and pass B per chunk from its
  checkpoint; each slot's gradients are reduced over the tile's pixels
  inside one block (no atomics; deterministic).  It takes the forward's
  stop chunks instead of voting again.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``.launches``; it runs the plain PyTorch version beside it only for CPU
tensors.  The plain versions (vectorised over tiles, looping over 128-slot
chunks with the same early-out rule and, for K2, the same decomposition)
are the reference the CUDA kernels are compared with on the card.

Slot matrix layout (16, S), as in the JAX package:
  [0] mean_x  [1] mean_y  [2] conic_a  [3] conic_b  [4] conic_c
  [5] opacity [6..7] pad  [8..15] channels (e.g. r, g, b, depth)
Tile t owns the run ``[pad_starts[t], pad_starts[t] + pad_counts[t])``;
runs are disjoint and CHUNK-aligned, as ``binning.build_tile_bins`` lays
them out.
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
    """Plain PyTorch K1: (16, S) slots -> (T, PIX, 8) tile images and the
    stop chunks (T,) int32, the number of chunks each tile composited
    before its early-out."""
    num_tiles = tiles_x * tiles_y
    dev = slot_data.device
    px, py = _pix_coords(num_tiles, tiles_x, dev)
    nchunks = pad_counts.long() // CHUNK
    carry = torch.zeros(num_tiles, PIX, 1, device=dev)      # log T
    accum = torch.zeros(num_tiles, PIX, C_MAX, device=dev)
    stop = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    max_chunks = int(nchunks.max()) if num_tiles else 0
    for ci in range(max_chunks):
        live = (ci < nchunks) & (torch.amax(carry, dim=(1, 2)) > LOG_EPS)
        if not bool(live.any()):
            break
        stop += live
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
    return torch.cat([accum[..., :C_MAX - 1], alpha_img], dim=-1), stop


def composite_fwd(slot_data, pad_starts, pad_counts, tiles_x, tiles_y):
    """K1: launches the CUDA kernel for CUDA tensors (counted in
    ``composite_fwd.launches``); the plain version for CPU tensors.
    Returns the tile images (T, PIX, 8) and the stop chunks (T,) int32,
    which ``composite_bwd`` takes.

    Replaces the Pallas ``_fwd_kernel`` (``artdeco_tpu/ops/splat/
    composite.py``).  On the H100 it is bound by each pixel's exp and FMAs
    per slot and their serial chain, not by memory: each 128-slot chunk
    (8 KB) is copied into shared memory and read by all 256 pixels, and its
    walk is split over four threads per pixel."""
    _check_inputs(slot_data, pad_starts, pad_counts, tiles_x, tiles_y)
    if slot_data.device.type == "cpu":
        return composite_fwd_plain(slot_data, pad_starts, pad_counts,
                                   tiles_x, tiles_y)
    if slot_data.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {slot_data.device}")
    num_tiles = tiles_x * tiles_y
    slot_data = slot_data.contiguous()
    S = slot_data.shape[1]
    if S % 4 or slot_data.data_ptr() % 16:
        # the chunks are copied 16 bytes at a time: rows start 16-byte aligned
        padded = slot_data.new_zeros(D_PAIR, S + -S % 4)
        padded[:, :S] = slot_data
        slot_data = padded
    out = torch.empty(num_tiles, PIX, C_MAX, device=slot_data.device)
    stop = torch.empty(num_tiles, dtype=torch.int32, device=slot_data.device)
    lib = kernels.load()
    # the launch runs on the host thread's current device: make it the data's
    with torch.cuda.device(slot_data.device):
        err = lib.artdeco_composite_fwd(
            slot_data.data_ptr(), slot_data.shape[1], pad_starts.data_ptr(),
            pad_counts.data_ptr(), num_tiles, tiles_x, out.data_ptr(), stop.data_ptr(),
            torch.cuda.current_stream(slot_data.device).cuda_stream,
        )
    kernels.check(err, "composite_fwd")
    composite_fwd.launches += 1
    return out, stop


composite_fwd.launches = 0


# ---------------------------------------------------------------------------
# K2: backward
# ---------------------------------------------------------------------------

def composite_bwd_plain(slot_data, pad_starts, pad_counts, tiles_x, tiles_y,
                        g_out, stop):
    """Plain PyTorch K2: d loss / d slot_data (16, S); slots outside every
    tile run get 0.  ``stop`` (T,) int32 is the forward's stop chunks.

    The kernel's decomposition, in log space: (1) each chunk's own log
    transmittance product and weighted-gradient mass, T starting at 1 in
    the chunk; (2) an exclusive scan over chunks into each chunk's starting
    checkpoint (log T, q), and pass A's results (final T, total mass) at
    the stop chunk; (3) pass B per chunk from its checkpoint, over every
    chunk of the run (no early-out)."""
    num_tiles = tiles_x * tiles_y
    dev = slot_data.device
    S = slot_data.shape[1]
    px, py = _pix_coords(num_tiles, tiles_x, dev)
    nchunks = pad_counts.long() // CHUNK
    g_alpha = g_out[..., C_MAX - 1:C_MAX]                    # (T, PIX, 1)
    g_c = torch.cat([g_out[..., :C_MAX - 1],
                     torch.zeros_like(g_alpha)], dim=-1)     # (T, PIX, 8)
    max_chunks = int(nchunks.max()) if num_tiles else 0

    def chunk(ci):
        has = ci < nchunks
        d, idx = _gather_chunk(slot_data, pad_starts, ci, has)
        alpha, e, dx, dy = _chunk_alpha(d, px, py)
        alpha = alpha * has[:, None, None]
        s = torch.log1p(-alpha)
        cum_excl = torch.cumsum(s, dim=-1) - s               # log T_local
        cg = g_c @ d[8:8 + C_MAX].permute(1, 0, 2)           # (T, PIX, CHUNK)
        return has, d, idx, alpha, e * has[:, None, None], dx, dy, s, cum_excl, cg

    # (1) chunk summaries
    log_p, mass = [], []
    for ci in range(max_chunks):
        _, _, _, alpha, _, _, _, s, cum_excl, cg = chunk(ci)
        log_p.append(torch.sum(s, dim=-1, keepdim=True))
        mass.append(torch.sum(alpha * torch.exp(cum_excl) * cg, dim=-1, keepdim=True))
    # (2) checkpoints at each chunk's start; entry max_chunks follows the last
    zero = torch.zeros(1, num_tiles, PIX, 1, device=dev)
    log_t0, q0 = zero, zero
    if max_chunks:
        log_t0 = torch.cat([zero, torch.cumsum(torch.stack(log_p), dim=0)])
        q0 = torch.cat([zero, torch.cumsum(torch.exp(log_t0[:-1]) * torch.stack(mass),
                                           dim=0)])
    at_stop = stop.long()[None, :, None, None].expand(1, num_tiles, PIX, 1)
    galpha_T = g_alpha * torch.exp(torch.gather(log_t0, 0, at_stop)[0])
    total_q = torch.gather(q0, 0, at_stop)[0]

    # (3) pass B per chunk
    grad = torch.zeros(D_PAIR, S + 1, device=dev)            # col S: dummy
    for ci in range(max_chunks):
        has, d, idx, alpha, e, dx, dy, s, cum_excl, cg = chunk(ci)
        Tj = torch.exp(cum_excl + log_t0[ci])
        w = alpha * Tj
        q = w * cg
        suffix = total_q - (torch.cumsum(q, dim=-1) + q0[ci])
        dl_da = cg * Tj + (galpha_T - suffix) * torch.reciprocal(1.0 - alpha)
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
    return grad[:, :S]


def composite_bwd(slot_data, pad_starts, pad_counts, tiles_x, tiles_y, g_out, stop):
    """K2: launches the CUDA kernels for CUDA tensors (one call, counted
    once in ``composite_bwd.launches``); the plain version for CPU tensors.
    ``stop`` is the stop chunks ``composite_fwd`` returned.

    Replaces the Pallas ``_bwd_kernel`` (``artdeco_tpu/ops/splat/
    composite.py``).  On the H100 it is bound by compute: pass B spends
    14 flops on alpha for every (pixel, slot) pair of a real slot of every
    run and, where alpha > 0, 63 more (50 for the gradient terms, 13 for
    the sums over the tile's pixels).  A serial walk per tile would fill
    the card with one block per tile, so the call runs three kernels:
    per-chunk summaries (P, Q), one
    scan per tile into per-chunk checkpoints (T, q), and pass B per chunk
    from its checkpoint, with each slot's 13 gradients summed over a warp by
    one 16-shuffle butterfly.  Each slot is written once (a slot belongs to
    one tile), with no global atomics: the result is deterministic."""
    _check_inputs(slot_data, pad_starts, pad_counts, tiles_x, tiles_y)
    num_tiles = tiles_x * tiles_y
    if g_out.shape != (num_tiles, PIX, C_MAX) or g_out.dtype != torch.float32:
        raise ValueError(f"g_out must be ({num_tiles}, {PIX}, {C_MAX}) float32")
    if stop.dtype != torch.int32 or stop.shape != (num_tiles,) \
            or stop.device != slot_data.device:
        raise ValueError(f"stop must be ({num_tiles},) int32 on {slot_data.device}")
    if slot_data.device.type == "cpu":
        return composite_bwd_plain(slot_data, pad_starts, pad_counts,
                                   tiles_x, tiles_y, g_out, stop)
    if slot_data.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {slot_data.device}")
    slot_data = slot_data.contiguous()
    g_out = g_out.contiguous()
    stop = stop.contiguous()
    S = slot_data.shape[1]
    # zeros: slots outside every run are never written by the kernels
    grad = torch.zeros_like(slot_data)
    # scratch: a (T, q) checkpoint per (chunk, pixel), then pass A's
    # results per (tile, pixel)
    ckpt = torch.empty((S // CHUNK + num_tiles) * PIX * 2, device=slot_data.device)
    lib = kernels.load()
    with torch.cuda.device(slot_data.device):
        err = lib.artdeco_composite_bwd(
            slot_data.data_ptr(), S, pad_starts.data_ptr(), pad_counts.data_ptr(),
            stop.data_ptr(), num_tiles, tiles_x, g_out.data_ptr(), ckpt.data_ptr(),
            grad.data_ptr(), torch.cuda.current_stream(slot_data.device).cuda_stream,
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
        out, stop = composite_fwd(slot_data, pad_starts, pad_counts, tiles_x, tiles_y)
        # the backward takes the forward's stop chunks: both use one vote
        ctx.save_for_backward(slot_data, pad_starts, pad_counts, stop)
        ctx.tiles = (tiles_x, tiles_y)
        return out

    @staticmethod
    def backward(ctx, g_out):
        slot_data, pad_starts, pad_counts, stop = ctx.saved_tensors
        g = composite_bwd(slot_data, pad_starts, pad_counts, *ctx.tiles,
                          g_out.contiguous(), stop)
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
