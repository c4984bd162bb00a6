"""The refine_matches descriptor search, per query, with K3.

Port of ``artdeco_tpu/ops/refine_dense.py``.  Per query n with current
match centre p, search the (2r+1)^2 window at dilations d = dilation_max..1
for the descriptor dot-product argmax; the running max (init +FLT_MIN)
persists across levels and the window re-centres on the current best after
every level (reference ``matching_kernels.cu:26-81``).

The JAX package makes the search dense in image-1 space (a claim pass, the
81-offset stencil ``_dense_best`` that the Pallas kernel ``_band_kernel`` in
``refine_pallas.py`` also computes, and a drain of collision losers),
because per-query gathers are slow on the TPU.  On the GPU they are not,
so the port searches per query: K3 (``csrc/refine.cu``, wrapper
``window_argmax``) walks each query's own window on every level in one
launch.  It gives the same positions; the claim pass and the loser drain
(and their dropped-loser telemetry, always 0) have no counterpart here.

Descriptors are rounded to bf16 (round to nearest even, as XLA's convert
does); products of two bf16 values are exact in f32 and the 24-channel sums
run in channel order, so K3 (which adds each product with an FMA) and
``window_argmax_plain`` (a multiply, then an add) agree bit for bit.
XLA may sum in another order, so a near-tie can pick another offset there.

K3's f32 instance serves ``refine_matches`` with ``compute_dtype`` None
(the JAX package's ``_refine_single`` in ``ops/matching.py``, the same
first-argmax search in float32, which refines every query whatever
``valid`` says): the same search over float32 descriptors, each product
rounded before it is added, as the plain version does.
"""

from __future__ import annotations

import torch

from artdeco_tpu_torch import kernels

FLT_MIN = 1.17549435e-38     # float32's smallest normal: the initial running max
DESC_DIM = 24                # channels K3 is built for (MASt3R's and the oracle's)
RADII = (2, 3, 4, 5)         # window radii K3 is built for (csrc/refine.cu)
_CHUNK = 8192                # queries per gather chunk of the plain version


def _check_inputs(D11b, D21b, p, valid):
    h, w, f = D11b.shape
    n = D21b.shape[0]
    if D11b.dtype not in (torch.bfloat16, torch.float32) or D21b.dtype != D11b.dtype:
        raise ValueError("window_argmax: descriptors must be both bfloat16 or both float32, "
                         f"got {D11b.dtype} and {D21b.dtype}")
    if D21b.shape != (n, f) or p.shape != (n, 2) or p.dtype != torch.int32 \
            or valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"window_argmax: bad shapes D11 {tuple(D11b.shape)} D21 "
                         f"{tuple(D21b.shape)} p {tuple(p.shape)} {p.dtype} valid "
                         f"{tuple(valid.shape)} {valid.dtype}")
    for name, a in (("D21", D21b), ("p", p), ("valid", valid)):
        if a.device != D11b.device:
            raise ValueError(f"window_argmax: {name} is on {a.device}, D11 on {D11b.device}")


def window_argmax_plain(D11b, D21b, p, valid, radius: int, d_max: int, d_min: int,
                        init_score: float):
    """Plain PyTorch K3 (both instances): the per-query search on levels
    d_max..d_min.

    Per chunk of queries, each channel's window samples are gathered from
    the zero-padded channel-major image (out-of-image samples read zeros
    and score 0.0), the scores are summed in f32 in channel order, and the
    first max of each level is taken.  Returns (p_new (n, 2) int32,
    running max (n,) f32)."""
    h, w, f = D11b.shape
    dev = D11b.device
    span = 2 * radius + 1
    u = p[:, 0].clone()
    v = p[:, 1].clone()
    best = torch.full((p.shape[0],), init_score, dtype=torch.float32, device=dev)
    act = torch.nonzero(valid).flatten()
    off = torch.arange(span, device=dev, dtype=torch.int32)
    for d in range(d_max, d_min - 1, -1):
        rd = radius * d
        Hp, Wp = h + 2 * rd, w + 2 * rd
        P = torch.nn.functional.pad(D11b.permute(2, 0, 1).float(), (rd, rd, rd, rd))
        P = P.reshape(f, Hp * Wp)
        for c0 in range(0, act.numel(), _CHUNK):
            ids = act[c0:c0 + _CHUNK]
            uq, vq = u[ids], v[ids]
            # padded coords of sample (i, j): (v + j*d, u + i*d); i-outer, j-inner.
            # Centres lie in the image on the main path; clamping keeps a wild
            # one's reads inside the padded image, where they read zeros
            rows = (vq[:, None, None] + off[None, None, :] * d).clamp(0, Hp - 1)
            cols = (uq[:, None, None] + off[None, :, None] * d).clamp(0, Wp - 1)
            lin = (rows * Wp + cols).reshape(-1).long()
            g = D21b[ids].float().T.contiguous()                   # (f, chunk)
            s = torch.zeros(len(ids), span * span, dtype=torch.float32, device=dev)
            for c in range(f):
                s.add_(torch.index_select(P[c], 0, lin).view_as(s).mul_(g[c][:, None]))
            bs, bo = torch.max(s, dim=1)          # first max (i outer, j inner)
            upd = bs > best[ids]
            best[ids] = torch.where(upd, bs, best[ids])
            u[ids] = torch.where(upd, uq - rd + (bo // span).int() * d, uq)
            v[ids] = torch.where(upd, vq - rd + (bo % span).int() * d, vq)
    return torch.stack([u, v], dim=-1), best


def window_argmax(D11b, D21b, p, valid, radius: int, d_max: int, d_min: int = 1,
                  init_score: float = FLT_MIN):
    """K3: the per-query window-argmax search of refine_matches.

    D11b (h, w, f) and D21b (n, f) both bf16 or both f32, p (n, 2) int32
    centres (u, v), valid (n,) bool.  Searches levels d_max..d_min with the
    running max starting at ``init_score``; returns (p_new (n, 2) int32,
    running max (n,) f32).  Launches the CUDA kernel for CUDA tensors
    (counted in ``window_argmax.launches``, the f32 instance in
    ``window_argmax.launches_f32``; radii ``RADII``, others raise); the
    plain version for CPU tensors.

    Replaces the Pallas ``_band_kernel`` (``artdeco_tpu/ops/refine_pallas.py``)."""
    _check_inputs(D11b, D21b, p, valid)
    if D11b.device.type == "cpu":
        return window_argmax_plain(D11b, D21b, p, valid, radius, d_max, d_min, init_score)
    if D11b.device.type != "cuda":
        raise ValueError(f"window_argmax: unsupported device {D11b.device}")
    h, w, f = D11b.shape
    if f != DESC_DIM:
        raise ValueError(f"window_argmax: K3 is built for {DESC_DIM} channels, got {f}")
    if radius not in RADII:
        raise ValueError(f"window_argmax: K3 is built for radii {RADII}, got {radius}")
    # the image as planes of 16 bytes a pixel (8 bf16 or 4 f32 channels:
    # a warp's load reads contiguous bytes); 16-byte query row loads
    f32 = D11b.dtype == torch.float32
    n_planes = 6 if f32 else 3
    planes = D11b.reshape(h, w, n_planes, f // n_planes).permute(2, 0, 1, 3).contiguous()
    if not D21b.is_contiguous() or D21b.data_ptr() % 16:
        D21b = D21b.clone()
    p, valid = p.contiguous(), valid.contiguous()
    n = p.shape[0]
    p_out = torch.empty_like(p)
    score = torch.empty(n, dtype=torch.float32, device=p.device)
    fn = kernels.load().artdeco_refine_f32 if f32 else kernels.load().artdeco_refine
    # the launch runs on the host thread's current device: make it the data's
    with torch.cuda.device(p.device):
        err = fn(
            planes.data_ptr(), D21b.data_ptr(), p.data_ptr(), valid.data_ptr(), n, h, w,
            radius, d_max, d_min, init_score, p_out.data_ptr(), score.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream)
    kernels.check(err, "window_argmax")
    if f32:
        window_argmax.launches_f32 += 1
    else:
        window_argmax.launches += 1
    return p_out, score


window_argmax.launches = 0
window_argmax.launches_f32 = 0


def refine_matches_dense_single(D11, D21, p1, radius: int = 4, dilation_max: int = 5,
                                valid=None, dtype: torch.dtype = torch.bfloat16):
    """Coarse-to-fine descriptor search of one image pair.

    D11 (h, w, f) descriptors of frame 1, D21 (n, f) query descriptors,
    p1 (n, 2) int current matches into frame 1, valid (n,) bool queries to
    refine (None = all; invalid queries keep their position), ``dtype``
    the descriptors' type in the search (bf16, or f32 for K3's f32
    instance).  Returns p_new (n, 2) int32 — the JAX function's first
    result."""
    n = p1.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=p1.device)
    D11b = D11.to(dtype).contiguous()
    D21b = D21.reshape(n, -1).to(dtype).contiguous()
    p_new, _ = window_argmax(D11b, D21b, p1.to(torch.int32).contiguous(),
                             valid.reshape(n).to(torch.bool), radius, dilation_max, 1,
                             FLT_MIN)
    return p_new
