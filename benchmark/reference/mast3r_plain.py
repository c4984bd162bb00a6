"""Plain float32 MASt3R: the reference the model cells are judged against.

A frozen copy of the published architecture (naver's AsymmetricMASt3R,
``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric``: a siamese ViT encoder
with RoPE2D, two cross-attention decoders, DPT heads for points and
confidence, a local-feature MLP head for descriptors), written for this
benchmark in plain PyTorch: float32 throughout, attention as two matmuls
and a softmax, no fused kernel.  It imports nothing of the measured
program.  The parameter names are the released checkpoint's
(``enc_blocks.{i}.attn.qkv``, ``dec_blocks2.{i}.cross_attn.projq``, ...),
so one state dict loads both this model and the program's.  refinenet4's
``resConfUnit1`` (no skip input reaches it) is left out, as the program
leaves it out.

``trunk_quant="fp8"`` is the control: every matmul and convolution of the
trunk (patch embedding, encoder and decoder blocks, decoder embedding)
takes its operands rounded to float8 e4m3 with one scale per tensor, the
precision below the program's bfloat16 trunk.  The heads stay float32.

Callers turn TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``
and ``torch.backends.cudnn.allow_tf32 = False``) before they run it on a
card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6
FP8_MAX = 448.0                  # largest finite float8 e4m3 value


@dataclasses.dataclass(frozen=True)
class Widths:
    """The architecture's sizes (the benchmark's configuration file holds
    the published ones)."""
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_freq: float = 100.0
    local_feat_dim: int = 24
    dpt_feature_dim: int = 256
    dpt_layer_dims: Sequence[int] = (96, 192, 384, 768)
    conf_vmin: float = 1.0
    desc_conf_vmin: float = 0.0


def widths_from(cfg: dict) -> Widths:
    keys = {f.name for f in dataclasses.fields(Widths)}
    kw = {k: v for k, v in cfg.items() if k in keys}
    if "dpt_layer_dims" in kw:
        kw["dpt_layer_dims"] = tuple(kw["dpt_layer_dims"])
    return Widths(**kw)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), returned in float32."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class QLinear(nn.Linear):
    """A linear layer whose operands can be rounded to float8 (the control)."""
    quant = False

    def forward(self, x):
        if not self.quant:
            return F.linear(x, self.weight, self.bias)
        return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)


def rope2d(tokens, positions, freq: float):
    """2D rotary embedding of (B, heads, N, D) at (B, N, 2) = (y, x): the
    first half of D rotates by y, the second by x (CroCo's RoPE2D)."""
    d_half = tokens.shape[-1] // 2
    d_quarter = d_half // 2
    inv_freq = 1.0 / (freq ** (torch.arange(0, d_half, 2, dtype=torch.float32,
                                            device=tokens.device) / d_half))

    def rope1d(tok, pos1d):
        ang = pos1d[:, None, :, None].to(torch.float32) * inv_freq
        ang = torch.cat([ang, ang], dim=-1)
        rot = torch.cat([-tok[..., d_quarter:], tok[..., :d_quarter]], dim=-1)
        return tok * torch.cos(ang) + rot * torch.sin(ang)

    return torch.cat([rope1d(tokens[..., :d_half], positions[..., 0]),
                      rope1d(tokens[..., d_half:], positions[..., 1])], dim=-1)


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over (B, heads, N, D) -> (B, N, heads*D)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    out = torch.matmul(torch.softmax(s, dim=-1), v)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, rope_freq):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        self.qkv = QLinear(dim, 3 * dim)
        self.proj = QLinear(dim, dim)

    def forward(self, x, xpos):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        return self.proj(attention(rope2d(q, xpos, self.rope_freq),
                                   rope2d(k, xpos, self.rope_freq), v))


class CrossAttention(nn.Module):
    def __init__(self, dim, num_heads, rope_freq):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        self.projq = QLinear(dim, dim)
        self.projk = QLinear(dim, dim)
        self.projv = QLinear(dim, dim)
        self.proj = QLinear(dim, dim)

    def forward(self, query, key, value, qpos, kpos):
        b, _, c = query.shape

        def heads(x):
            return x.reshape(b, -1, self.num_heads, c // self.num_heads).transpose(1, 2)

        q = rope2d(heads(self.projq(query)), qpos, self.rope_freq)
        k = rope2d(heads(self.projk(key)), kpos, self.rope_freq)
        return self.proj(attention(q, k, heads(self.projv(value))))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out, linear=QLinear):
        super().__init__()
        self.fc1 = linear(dim, hidden)
        self.fc2 = linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class EncoderBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, rope_freq):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, rope_freq)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, rope_freq):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, rope_freq)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_y = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = CrossAttention(dim, num_heads, rope_freq)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))


class QConv2d(nn.Conv2d):
    quant = False

    def forward(self, x):
        if not self.quant:
            return super().forward(x)
        return self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, dim):
        super().__init__()
        self.proj = QConv2d(3, dim, patch_size, stride=patch_size)


class ResidualConvUnit(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


def upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class FeatureFusion(nn.Module):
    def __init__(self, f, with_skip=True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(upsample2(self.resConfUnit2(x)))


class _Scratch(nn.Module):
    def __init__(self, layer_dims, f):
        super().__init__()
        for i, d in enumerate(layer_dims, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(d, f, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i}", FeatureFusion(f, with_skip=i != 4))


class _Interpolate(nn.Module):
    def forward(self, x):
        return upsample2(x)


class DPTHead(nn.Module):
    def __init__(self, c: Widths, num_channels=4):
        super().__init__()
        ld, f = c.dpt_layer_dims, c.dpt_feature_dim
        dims = (c.enc_embed_dim, c.dec_embed_dim, c.dec_embed_dim, c.dec_embed_dim)
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(dims[0], ld[0], 1), nn.ConvTranspose2d(ld[0], ld[0], 4, 4)),
            nn.Sequential(nn.Conv2d(dims[1], ld[1], 1), nn.ConvTranspose2d(ld[1], ld[1], 2, 2)),
            nn.Sequential(nn.Conv2d(dims[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(dims[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = _Scratch(ld, f)
        self.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), _Interpolate(),
            nn.Conv2d(f // 2, f // 2, 3, padding=1), nn.ReLU(),
            nn.Conv2d(f // 2, num_channels, 1))

    def forward(self, hooks, nh, nw):
        maps = [act(t.transpose(1, 2).reshape(t.shape[0], t.shape[2], nh, nw))
                for act, t in zip(self.act_postprocess, hooks)]
        s = self.scratch
        r1, r2, r3, r4 = (s.layer1_rn(maps[0]), s.layer2_rn(maps[1]), s.layer3_rn(maps[2]),
                          s.layer4_rn(maps[3]))
        p4 = s.refinenet4(r4)[:, :, :r3.shape[2], :r3.shape[3]]
        p1 = s.refinenet1(s.refinenet2(s.refinenet3(p4, r3), r2), r1)
        return self.head(p1)


class HeadPair(nn.Module):
    def __init__(self, c: Widths):
        super().__init__()
        idim = c.enc_embed_dim + c.dec_embed_dim
        self.dpt = DPTHead(c)
        self.head_local_features = Mlp(idim, 4 * idim, (c.local_feat_dim + 1) * c.patch_size ** 2,
                                       linear=nn.Linear)

    def local_features(self, enc_tok, dec_tok, nh, nw, p):
        x = self.head_local_features(torch.cat([enc_tok, dec_tok], dim=-1))
        b = x.shape[0]
        x = x.reshape(b, nh, nw, -1, p, p).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, nh * p, nw * p, -1)


class PlainMASt3R(nn.Module):
    def __init__(self, c: Widths = Widths()):
        super().__init__()
        self.c = c
        self.patch_embed = PatchEmbed(c.patch_size, c.enc_embed_dim)
        self.enc_blocks = nn.ModuleList([EncoderBlock(c.enc_embed_dim, c.enc_num_heads,
                                                      c.mlp_ratio, c.rope_freq)
                                         for _ in range(c.enc_depth)])
        self.enc_norm = nn.LayerNorm(c.enc_embed_dim, eps=LN_EPS)
        self.decoder_embed = QLinear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList([DecoderBlock(c.dec_embed_dim, c.dec_num_heads,
                                                      c.mlp_ratio, c.rope_freq)
                                         for _ in range(c.dec_depth)])
        self.dec_blocks2 = nn.ModuleList([DecoderBlock(c.dec_embed_dim, c.dec_num_heads,
                                                       c.mlp_ratio, c.rope_freq)
                                          for _ in range(c.dec_depth)])
        self.dec_norm = nn.LayerNorm(c.dec_embed_dim, eps=LN_EPS)
        self.downstream_head1 = HeadPair(c)
        self.downstream_head2 = HeadPair(c)

    def set_trunk_quant(self, mode):
        """None: float32; "fp8": the trunk's operands rounded to float8."""
        if mode not in (None, "fp8"):
            raise ValueError(f"trunk_quant {mode!r}: None or 'fp8'")
        for m in self.modules():
            if isinstance(m, (QLinear, QConv2d)):
                m.quant = mode == "fp8"
        return self

    def encode(self, img):
        """img (B, 3, H, W) in [-1, 1] -> (tokens (B, N, C), pos (B, N, 2))."""
        c = self.c
        b, _, h, w = img.shape
        x = self.patch_embed.proj(img.float()).flatten(2).transpose(1, 2)
        nh, nw = h // c.patch_size, w // c.patch_size
        ys, xs = torch.meshgrid(torch.arange(nh, device=img.device),
                                torch.arange(nw, device=img.device), indexing="ij")
        pos = torch.stack([ys, xs], dim=-1).reshape(1, nh * nw, 2).expand(b, -1, -1)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos

    def decode(self, f1, pos1, f2, pos2):
        c = self.c
        hook_ids = (c.dec_depth * 2 // 4, c.dec_depth * 3 // 4)
        out1, out2 = [f1], [f2]
        cur1, cur2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for i, (b1, b2) in enumerate(zip(self.dec_blocks, self.dec_blocks2)):
            cur1, cur2 = b1(cur1, cur2, pos1, pos2), b2(cur2, cur1, pos2, pos1)
            if i + 1 in hook_ids:
                out1.append(cur1)
                out2.append(cur2)
        out1.append(self.dec_norm(cur1))
        out2.append(self.dec_norm(cur2))
        return out1, out2

    def head(self, head_num, hooks, nh, nw):
        hp = self.downstream_head1 if head_num == 1 else self.downstream_head2
        fmap = hp.dpt(hooks, nh, nw).permute(0, 2, 3, 1)
        lfeat = hp.local_features(hooks[0], hooks[-1], nh, nw, self.c.patch_size)
        return postprocess(fmap, lfeat, self.c)

    def pair(self, f1, pos1, f2, pos2, hw):
        """Both decoders and heads of view 1 = (f1, pos1), view 2 = (f2, pos2)."""
        nh, nw = hw[0] // self.c.patch_size, hw[1] // self.c.patch_size
        d1, d2 = self.decode(f1, pos1, f2, pos2)
        return self.head(1, d1, nh, nw), self.head(2, d2, nh, nw)


def postprocess(fmap, lfeat, c: Widths) -> dict:
    """MASt3R's output activations: exp-distance points, 1 + exp
    confidence, unit descriptors, exp descriptor confidence."""
    xyz = fmap[..., 0:3]
    d = torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True) + 1e-16)
    pts3d = xyz / torch.clamp_min(d, 1e-8) * torch.expm1(d)
    conf = c.conf_vmin + torch.exp(fmap[..., 3])
    desc = lfeat[..., :c.local_feat_dim]
    desc = desc * torch.rsqrt(torch.sum(desc * desc, dim=-1, keepdim=True) + 1e-16)
    desc_conf = c.desc_conf_vmin + torch.exp(lfeat[..., c.local_feat_dim])
    return dict(pts3d=pts3d, conf=conf, desc=desc, desc_conf=desc_conf)


def empty_model(c: Widths, device) -> PlainMASt3R:
    with torch.device("meta"):
        model = PlainMASt3R(c)
    return model.to_empty(device=device)


def draw_state_dict(c: Widths, seed: int, device, std: float = 0.02) -> dict:
    """Seeded weights drawn on ``device`` in one call: every weight and bias
    normal(0, ``std``) (the init convention of the model's training code),
    LayerNorms at unit scale and zero shift, and the point heads' z bias 1
    so the points lie in front of the camera.  Returns a float32 state dict
    with the checkpoint's names (views of one buffer)."""
    shapes = [(n, p.shape) for n, p in empty_model(c, "meta").named_parameters()]
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device).mul_(std)
    sd, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if ".norm" in name or name.startswith(("enc_norm", "dec_norm")):
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        sd[name] = t
    for h in (1, 2):
        sd[f"downstream_head{h}.dpt.head.4.bias"][2] = 1.0
    return sd


def build(c: Widths, state_dict: dict, device, trunk_quant=None) -> PlainMASt3R:
    model = empty_model(c, device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval().set_trunk_quant(trunk_quant)
