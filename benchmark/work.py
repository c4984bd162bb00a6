"""The yardstick's arithmetic: the card's published peaks, and the work a
call needs, counted from shapes and the configuration's widths alone (the
same count whatever implements the call).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12       # bf16 / fp16 on the tensor cores
PEAK_BYTES = 3.35e12           # HBM3, bytes/s


def k3_bytes(h: int, w: int, channels: int) -> int:
    """Device memory traffic of one row of K3 (the refine's window argmax,
    ``csrc/refine.cu``) over an h x w pair, each input read once and each
    output written once: frame 1's bf16 descriptors (h w c), the h w
    queries' bf16 descriptors, int32 (u, v) positions and bool validity
    in; int32 positions and the f32 best score out."""
    n = h * w
    return 2 * h * w * channels + 2 * n * channels + 8 * n + n + 8 * n + 4 * n


def _linear(n: int, cin: int, cout: int) -> int:
    return 2 * n * cin * cout


def _conv(out_px: int, cin: int, cout: int, k: int) -> int:
    return 2 * out_px * cin * cout * k * k


def _attention(nq: int, nk: int, dim: int) -> int:
    """q k^T and p v over all heads (dim = heads * head size)."""
    return 2 * nq * nk * dim * 2


def mast3r_flops(widths, h: int, w: int) -> tuple:
    """(encode, decode + heads) FLOPs of MASt3R on an h x w image: 2 per
    multiply-add of every matmul, attention product and convolution
    (transposed ones counted over their input); biases, norms,
    activations, softmax, RoPE and resampling not counted.  Encode is one
    image; decode + heads is both decoders (cross-attending) and both
    heads of one pair."""
    c = widths
    p = c.patch_size
    nh, nw = h // p, w // p
    n = nh * nw
    C, D = c.enc_embed_dim, c.dec_embed_dim
    mlp_e, mlp_d = int(C * c.mlp_ratio), int(D * c.mlp_ratio)
    enc = _conv(n, 3, C, p)
    enc += c.enc_depth * (_linear(n, C, 3 * C) + _attention(n, n, C) + _linear(n, C, C)
                          + _linear(n, C, mlp_e) + _linear(n, mlp_e, C))
    dec_block = (_linear(n, D, 3 * D) + _attention(n, n, D) + _linear(n, D, D)      # self
                 + 4 * _linear(n, D, D) + _attention(n, n, D)                        # cross
                 + _linear(n, D, mlp_d) + _linear(n, mlp_d, D))
    dec = 2 * (_linear(n, C, D) + c.dec_depth * dec_block)
    ld, f = c.dpt_layer_dims, c.dpt_feature_dim
    n3 = ((nh + 1) // 2) * ((nw + 1) // 2)          # the stride-2 map of hook 4
    s0, s1, s2 = 16 * n, 4 * n, n                    # spatial sizes of hooks 1-3
    dpt = (_linear(n, C, ld[0]) + _conv(n, ld[0], ld[0], 4)               # 1x1, deconv x4
           + _linear(n, D, ld[1]) + _conv(n, ld[1], ld[1], 2)             # 1x1, deconv x2
           + _linear(n, D, ld[2])
           + _linear(n, D, ld[3]) + _conv(n3, ld[3], ld[3], 3))           # 1x1, 3x3 s2
    dpt += (_conv(s0, ld[0], f, 3) + _conv(s1, ld[1], f, 3) + _conv(s2, ld[2], f, 3)
            + _conv(n3, ld[3], f, 3))                                      # layer_rn
    rcu = 2 * 9 * 2 * f * f                          # a residual conv unit, per pixel
    dpt += n3 * rcu + 4 * n3 * f * f * 2             # refinenet4 (no skip)
    for s in (s2, s1, s0):                           # refinenet3, 2, 1
        dpt += 2 * s * rcu + 4 * s * f * f * 2
    hp = 64 * n                                      # after refinenet1
    dpt += _conv(hp, f, f // 2, 3) + _conv(4 * hp, f // 2, f // 2, 3) + _conv(4 * hp, f // 2, 4, 1)
    idim = C + D
    local = _linear(n, idim, 4 * idim) + _linear(n, 4 * idim, (c.local_feat_dim + 1) * p * p)
    return enc, dec + 2 * (dpt + local)
