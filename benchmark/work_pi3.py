"""Pi3's work, counted from shapes and the configuration's widths alone:
2 FLOPs per multiply-add of every matmul, attention product and
convolution; biases, norms, activations, softmax, RoPE, the position
embedding's resize, the SVD and the unprojection not counted (as
``work.mast3r_flops`` counts).  One call is one joint run over ``n``
frames of ``h`` x ``w``, whose global blocks attend over all n frames, so
the count grows with n squared there.
"""

from __future__ import annotations

from benchmark.work import _attention, _conv, _linear


def _block(n_seq: int, tokens: int, dim: int, mlp_ratio: float) -> int:
    """One pre-norm block over ``n_seq`` sequences of ``tokens`` tokens:
    qkv, attention within each sequence, projection, MLP."""
    t = n_seq * tokens
    hidden = int(dim * mlp_ratio)
    return (_linear(t, dim, 3 * dim) + n_seq * _attention(tokens, tokens, dim)
            + _linear(t, dim, dim) + _linear(t, dim, hidden) + _linear(t, hidden, dim))


def pi3_global_flops(widths, h: int, w: int, n: int) -> int:
    """The decoder's global blocks (its odd ones) of one joint run: each a
    block over all n frames' register and patch tokens as one sequence."""
    c = widths
    tokens = c.dec_registers + (h // c.patch_size) * (w // c.patch_size)
    return (c.dec_depth // 2) * _block(1, n * tokens, c.dec_embed_dim, c.mlp_ratio)


def pi3_flops(widths, h: int, w: int, n: int) -> int:
    """Every FLOP of one joint run of Pi3 over n frames of h x w: encoder,
    decoder (frame-local and global blocks) and the three heads."""
    c = widths
    p = c.patch_size
    n_patch = (h // p) * (w // p)
    C, D, Hd, cd = c.enc_embed_dim, c.dec_embed_dim, c.head_dim, c.camera_dim
    enc = n * _conv(n_patch, 3, C, p)
    enc += c.enc_depth * _block(n, 1 + c.enc_registers + n_patch, C, c.mlp_ratio)
    tokens = c.dec_registers + n_patch
    dec = (c.dec_depth - c.dec_depth // 2) * _block(n, tokens, D, c.mlp_ratio)
    dec += pi3_global_flops(c, h, w, n)
    heads = 0
    for out in (Hd, Hd, cd):
        heads += (_linear(n * tokens, 2 * D, Hd) + c.head_depth * _block(n, tokens, Hd,
                                                                          c.mlp_ratio)
                  + _linear(n * tokens, Hd, out))
    pix = n * n_patch
    heads += _linear(pix, Hd, 3 * p * p) + _linear(pix, Hd, p * p)        # point, conf heads
    heads += 2 * 3 * _linear(pix, cd, cd)                                 # camera res_conv
    heads += 2 * _linear(n, cd, cd) + _linear(n, cd, 3) + _linear(n, cd, 9)
    return enc + dec + heads
