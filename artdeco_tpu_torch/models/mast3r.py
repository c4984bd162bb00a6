"""MASt3R two-view pointmap regression network in PyTorch.

Port of ``artdeco_tpu/models/mast3r.py`` (the reference's AsymmetricMASt3R:
a siamese ViT-L encoder with RoPE2D, two cross-attention decoders, DPT
heads for points and confidence, and a local-feature MLP head for
descriptors).  The modules carry the released checkpoint's parameter
names (``enc_blocks.{i}.attn.qkv``, ``dec_blocks2.{i}.cross_attn.projq``,
``downstream_head1.dpt.act_postprocess.0.1``, ...), so ``load_state_dict``
takes a released ``.pth`` or ``.safetensors`` dict as it is.  Of those
tensors, refinenet4's ``resConfUnit1`` (it has no skip input) is dead:
``load_mast3r_state_dict`` drops exactly those 8 keys and loads the rest
strictly.  ``state_dict_from_flax`` carries a JAX package params tree
across (the inverse of its ``convert_state_dict``).

Dtypes follow the JAX package, block by block: with ``compute_dtype``
bfloat16 the patch embedding, the transformer blocks' linear layers and
the decoder embedding hold bf16 weights (cast once at load: the same
round-to-nearest-even that JAX applies on every call) and the residual
stream is bf16; LayerNorms run in float32 and cast back; attention takes
bf16 q/k/v (f32 logits and softmax inside); the encoder's and decoder's
final norms, the DPT heads and the local-feature head run in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6          # flax's LayerNorm default


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
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
    compute_dtype: torch.dtype = torch.bfloat16


def tiny_config(**kw) -> MASt3RConfig:
    """Small config for tests (the JAX package's ``tiny_config``)."""
    return MASt3RConfig(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
        dec_embed_dim=48, dec_depth=4, dec_num_heads=4,
        dpt_feature_dim=32, dpt_layer_dims=(16, 24, 32, 48),
        local_feat_dim=8, **kw,
    )


# ---------------------------------------------------------------------------
# RoPE2D
# ---------------------------------------------------------------------------

def rope2d(tokens: torch.Tensor, positions: torch.Tensor, freq: float) -> torch.Tensor:
    """2D rotary embedding of ``tokens`` (B, heads, N, D) at integer
    ``positions`` (B, N, 2) = (y, x): the first half of D rotates by y,
    the second by x.  cos and sin are cast to the tokens' dtype, so with
    bf16 tokens the rotation runs in bf16, as in the JAX package."""
    d_half = tokens.shape[-1] // 2
    d_quarter = d_half // 2
    inv_freq = 1.0 / (freq ** (torch.arange(0, d_half, 2, dtype=torch.float32,
                                            device=tokens.device) / d_half))

    def rope1d(tok, pos1d):
        ang = pos1d[:, None, :, None].to(torch.float32) * inv_freq
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = torch.cos(ang).to(tok.dtype), torch.sin(ang).to(tok.dtype)
        rot = torch.cat([-tok[..., d_quarter:], tok[..., :d_quarter]], dim=-1)
        return tok * cos + rot * sin

    return torch.cat([rope1d(tokens[..., :d_half], positions[..., 0]),
                      rope1d(tokens[..., d_half:], positions[..., 1])], dim=-1)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``norm`` (float32 weights) over x promoted to float32, cast to ``dtype``."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


def attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, heads, N, D) -> (B, N, heads*D)."""
    out = F.scaled_dot_product_attention(q, k, v)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


# ---------------------------------------------------------------------------
# Transformer blocks
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rope_freq: float):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, xpos):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = rope2d(q, xpos, self.rope_freq)
        k = rope2d(k, xpos, self.rope_freq)
        return self.proj(attention(q, k, v))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rope_freq: float):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, qpos, kpos):
        b, _, c = query.shape

        def heads(x):
            return x.reshape(b, -1, self.num_heads, c // self.num_heads).transpose(1, 2)

        q = rope2d(heads(self.projq(query)), qpos, self.rope_freq)
        k = rope2d(heads(self.projk(key)), kpos, self.rope_freq)
        return self.proj(attention(q, k, heads(self.projv(value))))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, rope_freq: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, rope_freq)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, xpos):
        x = x + self.attn(layer_norm(self.norm1, x, x.dtype), xpos)
        return x + self.mlp(layer_norm(self.norm2, x, x.dtype))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, rope_freq: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, rope_freq)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_y = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = CrossAttention(dim, num_heads, rope_freq)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(layer_norm(self.norm1, x, x.dtype), xpos)
        y_ = layer_norm(self.norm_y, y, x.dtype)
        x = x + self.cross_attn(layer_norm(self.norm2, x, x.dtype), y_, y_, xpos, ypos)
        return x + self.mlp(layer_norm(self.norm3, x, x.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


# ---------------------------------------------------------------------------
# DPT head
# ---------------------------------------------------------------------------

class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


def upsample2(x):
    """Bilinear x2 with align_corners=True (output i samples i(n-1)/(2n-1)),
    the JAX package's ``_upsample2``, over NCHW."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class FeatureFusion(nn.Module):
    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(upsample2(self.resConfUnit2(x)))


class _Scratch(nn.Module):
    def __init__(self, layer_dims, f: int):
        super().__init__()
        for i, d in enumerate(layer_dims, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(d, f, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i}", FeatureFusion(f, with_skip=i != 4))


class _Interpolate(nn.Module):
    def forward(self, x):
        return upsample2(x)


class DPTHead(nn.Module):
    """DPT over four hooked token maps -> (B, num_channels, H, W), float32."""

    def __init__(self, cfg: MASt3RConfig, num_channels: int = 4):
        super().__init__()
        ld, f = cfg.dpt_layer_dims, cfg.dpt_feature_dim
        dims = (cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.dec_embed_dim, cfg.dec_embed_dim)
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

    def forward(self, hooks, nh: int, nw: int):
        maps = [act(t.transpose(1, 2).reshape(t.shape[0], t.shape[2], nh, nw))
                for act, t in zip(self.act_postprocess, hooks)]
        s = self.scratch
        r1, r2, r3, r4 = (s.layer1_rn(maps[0]), s.layer2_rn(maps[1]), s.layer3_rn(maps[2]),
                          s.layer4_rn(maps[3]))
        p4 = s.refinenet4(r4)[:, :, :r3.shape[2], :r3.shape[3]]
        p3 = s.refinenet3(p4, r3)
        p2 = s.refinenet2(p3, r2)
        p1 = s.refinenet1(p2, r1)
        return self.head(p1)


class _HeadPair(nn.Module):
    """``downstream_head{1,2}``: the DPT and the local-feature MLP."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        self.dpt = DPTHead(cfg)
        self.head_local_features = Mlp(idim, 4 * idim,
                                       (cfg.local_feat_dim + 1) * cfg.patch_size ** 2)

    def local_features(self, enc_tok, dec_tok, nh: int, nw: int, p: int):
        """MLP over cat(enc, dec) tokens, pixel-shuffled:
        (b, nh, nw, C, p, p) -> (b, nh*p, nw*p, C)."""
        x = self.head_local_features(torch.cat([enc_tok, dec_tok], dim=-1))
        b = x.shape[0]
        x = x.reshape(b, nh, nw, -1, p, p).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, nh * p, nw * p, -1)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class MASt3R(nn.Module):
    def __init__(self, cfg: MASt3RConfig = MASt3RConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embed = PatchEmbed(c.patch_size, c.enc_embed_dim)
        self.enc_blocks = nn.ModuleList([
            EncoderBlock(c.enc_embed_dim, c.enc_num_heads, c.mlp_ratio, c.rope_freq)
            for _ in range(c.enc_depth)])
        self.enc_norm = nn.LayerNorm(c.enc_embed_dim, eps=LN_EPS)
        self.decoder_embed = nn.Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio, c.rope_freq)
            for _ in range(c.dec_depth)])
        self.dec_blocks2 = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio, c.rope_freq)
            for _ in range(c.dec_depth)])
        self.dec_norm = nn.LayerNorm(c.dec_embed_dim, eps=LN_EPS)
        self.downstream_head1 = _HeadPair(c)
        self.downstream_head2 = _HeadPair(c)
        self.set_compute_dtype()

    def set_compute_dtype(self):
        """The trunk's linear and patch weights in ``cfg.compute_dtype``;
        norms and heads stay float32."""
        dt = self.cfg.compute_dtype
        self.patch_embed.to(dt)
        self.decoder_embed.to(dt)
        for blk in (*self.enc_blocks, *self.dec_blocks, *self.dec_blocks2):
            for m in blk.modules():
                if isinstance(m, nn.Linear):
                    m.to(dt)
        return self

    # -- pieces ----------------------------------------------------------
    def encode(self, img):
        """img (B, 3, H, W) in [-1, 1] -> (tokens (B, N, C) float32,
        pos (B, N, 2) int64 (y, x))."""
        c = self.cfg
        b, _, h, w = img.shape
        dt = c.compute_dtype
        x = self.patch_embed.proj(img.to(dt))
        nh, nw = h // c.patch_size, w // c.patch_size
        x = x.flatten(2).transpose(1, 2)
        ys, xs = torch.meshgrid(torch.arange(nh, device=img.device),
                                torch.arange(nw, device=img.device), indexing="ij")
        pos = torch.stack([ys, xs], dim=-1).reshape(1, nh * nw, 2).expand(b, -1, -1)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return layer_norm(self.enc_norm, x, torch.float32), pos

    def decode(self, f1, pos1, f2, pos2):
        """Both decoders; returns the hooks of each view: [enc, dec at
        depth/2, dec at 3 depth/4, dec_norm(final)], all float32."""
        c = self.cfg
        dt = c.compute_dtype
        hook_ids = (c.dec_depth * 2 // 4, c.dec_depth * 3 // 4)
        out1, out2 = [f1], [f2]
        cur1, cur2 = self.decoder_embed(f1.to(dt)), self.decoder_embed(f2.to(dt))
        for i, (b1, b2) in enumerate(zip(self.dec_blocks, self.dec_blocks2)):
            cur1, cur2 = b1(cur1, cur2, pos1, pos2), b2(cur2, cur1, pos2, pos1)
            if i + 1 in hook_ids:
                out1.append(cur1.float())
                out2.append(cur2.float())
        out1.append(layer_norm(self.dec_norm, cur1, torch.float32))
        out2.append(layer_norm(self.dec_norm, cur2, torch.float32))
        return out1, out2

    def head(self, head_num: int, hooks, nh: int, nw: int) -> dict:
        hp = self.downstream_head1 if head_num == 1 else self.downstream_head2
        fmap = hp.dpt(hooks, nh, nw).permute(0, 2, 3, 1)
        lfeat = hp.local_features(hooks[0], hooks[-1], nh, nw, self.cfg.patch_size)
        return postprocess(fmap, lfeat, self.cfg)

    def forward(self, img1, img2):
        """The symmetric forward: (res1, res2) dicts of pts3d (B, H, W, 3),
        conf (B, H, W), desc (B, H, W, D), desc_conf (B, H, W); res2's
        points are in view 1's frame."""
        f1, pos1 = self.encode(img1)
        f2, pos2 = self.encode(img2)
        d1, d2 = self.decode(f1, pos1, f2, pos2)
        nh, nw = img1.shape[2] // self.cfg.patch_size, img1.shape[3] // self.cfg.patch_size
        return self.head(1, d1, nh, nw), self.head(2, d2, nh, nw)


def postprocess(fmap, lfeat, cfg: MASt3RConfig) -> dict:
    """exp-distance points, 1 + exp confidence, unit descriptors and the
    descriptor confidence (``desc_conf_vmin`` 0: no +1)."""
    xyz = fmap[..., 0:3].float()
    d = torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True) + 1e-16)
    pts3d = xyz / torch.clamp_min(d, 1e-8) * torch.expm1(d)
    conf = cfg.conf_vmin + torch.exp(fmap[..., 3].float())
    desc = lfeat[..., :cfg.local_feat_dim].float()
    desc = desc * torch.rsqrt(torch.sum(desc * desc, dim=-1, keepdim=True) + 1e-16)
    desc_conf = cfg.desc_conf_vmin + torch.exp(lfeat[..., cfg.local_feat_dim].float())
    return dict(pts3d=pts3d, conf=conf, desc=desc, desc_conf=desc_conf)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

# the 8 checkpoint tensors no computation reads: refinenet4's resConfUnit1
# in both heads (refinenet4 has no skip input)
DEAD_KEYS = tuple(f"downstream_head{h}.dpt.scratch.refinenet4.resConfUnit1.{conv}.{p}"
                  for h in (1, 2) for conv in ("conv1", "conv2") for p in ("weight", "bias"))


def load_mast3r_state_dict(model: MASt3R, sd: dict) -> MASt3R:
    """Load a torch-layout state dict (released checkpoint or
    ``convert_mast3r.synth_state_dict``; tensors or numpy arrays): the 8
    dead keys are dropped, everything else loads strictly (a missing or
    unexpected key raises).  A checkpoint without ``dec_blocks2`` shares
    the first decoder's weights, as the JAX converter does."""
    sd = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    if not any(k.startswith("dec_blocks2.") for k in sd):
        sd.update({k.replace("dec_blocks.", "dec_blocks2.", 1): v for k, v in list(sd.items())
                   if k.startswith("dec_blocks.")})
    for k in DEAD_KEYS:
        sd.pop(k, None)
    model.load_state_dict(sd, strict=True)
    return model


def empty_mast3r(cfg: MASt3RConfig, device) -> MASt3R:
    """A model whose (uninitialised) weights are allocated on ``device``
    only, to be filled by ``load_mast3r_state_dict`` or ``random_mast3r``."""
    with torch.device("meta"):
        model = MASt3R(cfg)
    return model.to_empty(device=device)


def random_mast3r(cfg: MASt3RConfig, generator: torch.Generator, device) -> MASt3R:
    """A model on ``device`` with seeded random weights drawn there (no
    host copy): normal(0, 0.02) weights and biases, unit LayerNorms, as
    ``convert_mast3r.synth_state_dict`` draws them on the host; the
    regression heads' z bias is 1, so the points lie in front of the camera
    (a random network's z keeps one sign over the image, which can put
    every point behind it and leave the mapper nothing to map)."""
    model = empty_mast3r(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".norm" in name or name.startswith(("enc_norm", "dec_norm")):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=device) * 0.02)
        for head in (model.downstream_head1, model.downstream_head2):
            head.dpt.head[4].bias[2] = 1.0
    return model


def state_dict_from_flax(params: dict, cfg: MASt3RConfig = MASt3RConfig()) -> dict:
    """A JAX package params tree -> the torch-layout state dict (numpy):
    the inverse of ``convert_mast3r.convert_state_dict``.  Dense and Conv
    kernels are transposed back, ConvTranspose kernels un-flipped; the 8
    dead tensors have no flax leaf and are left out."""
    p = params.get("params", params)
    sd = {}
    a = np.asarray

    def dense(name, t):
        sd[f"{name}.weight"] = a(t["kernel"]).T.copy()
        sd[f"{name}.bias"] = a(t["bias"]).copy()

    def conv(name, t):
        sd[f"{name}.weight"] = np.ascontiguousarray(a(t["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in t:
            sd[f"{name}.bias"] = a(t["bias"]).copy()

    def deconv(name, t):
        w = a(t["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[f"{name}.weight"] = np.ascontiguousarray(w)
        sd[f"{name}.bias"] = a(t["bias"]).copy()

    def ln(name, t):
        sd[f"{name}.weight"] = a(t["scale"]).copy()
        sd[f"{name}.bias"] = a(t["bias"]).copy()

    def block(name, t):
        for k in ("norm1", "norm2", "norm3", "norm_y"):
            if k in t:
                ln(f"{name}.{k}", t[k])
        for k in ("qkv", "proj"):
            dense(f"{name}.attn.{k}", t["attn"][k])
        if "cross_attn" in t:
            for k in ("projq", "projk", "projv", "proj"):
                dense(f"{name}.cross_attn.{k}", t["cross_attn"][k])
        dense(f"{name}.mlp.fc1", t["mlp"]["fc1"])
        dense(f"{name}.mlp.fc2", t["mlp"]["fc2"])

    enc, dec = p["encoder"], p["decoder"]
    conv("patch_embed.proj", enc["patch_embed_proj"])
    ln("enc_norm", enc["enc_norm"])
    for i in range(cfg.enc_depth):
        block(f"enc_blocks.{i}", enc[f"enc_block_{i}"])
    dense("decoder_embed", dec["decoder_embed"])
    ln("dec_norm", dec["dec_norm"])
    for i in range(cfg.dec_depth):
        block(f"dec_blocks.{i}", dec[f"dec_block_{i}"])
        block(f"dec_blocks2.{i}", dec[f"dec_block2_{i}"])
    for h in (1, 2):
        t, d = p[f"head{h}_dpt"], f"downstream_head{h}.dpt"
        conv(f"{d}.act_postprocess.0.0", t["act1_conv"])
        deconv(f"{d}.act_postprocess.0.1", t["act1_deconv"])
        conv(f"{d}.act_postprocess.1.0", t["act2_conv"])
        deconv(f"{d}.act_postprocess.1.1", t["act2_deconv"])
        conv(f"{d}.act_postprocess.2.0", t["act3_conv"])
        conv(f"{d}.act_postprocess.3.0", t["act4_conv"])
        conv(f"{d}.act_postprocess.3.1", t["act4_conv2"])
        conv(f"{d}.head.0", t["head_conv1"])
        conv(f"{d}.head.2", t["head_conv2"])
        conv(f"{d}.head.4", t["head_conv3"])
        for i in range(1, 5):
            conv(f"{d}.scratch.layer{i}_rn", t[f"layer{i}_rn"])
            rn, tr = f"{d}.scratch.refinenet{i}", t[f"refinenet{i}"]
            for u, key in ((1, "rcu1"), (2, "rcu2")):
                if key in tr:
                    conv(f"{rn}.resConfUnit{u}.conv1", tr[key]["conv1"])
                    conv(f"{rn}.resConfUnit{u}.conv2", tr[key]["conv2"])
            conv(f"{rn}.out_conv", tr["out_conv"])
        loc = p[f"head{h}_local"]["head_local_features"]
        dense(f"downstream_head{h}.head_local_features.fc1", loc["fc1"])
        dense(f"downstream_head{h}.head_local_features.fc2", loc["fc2"])
    return sd
