"""DepthAnythingV2 monocular relative-depth network in PyTorch.

Port of ``artdeco_tpu/models/depth_anything.py``: a DINOv2 ViT encoder
without register tokens, four hooked intermediate layers (each through the
final LayerNorm, the cls token dropped) and a DPT fusion head, giving
relative inverse depth.  The encoder's blocks are the Pi3 port's
``BlockRope`` with RoPE off (a plain DINOv2 block); the position embedding
is resized from its 37x37 grid as ``jax.image.resize(..., "cubic")`` does
(``models/pi3.cubic_resize_matrix``).

The modules carry the released checkpoint's names (``pretrained.blocks.{i}``,
``depth_head.projects.{i}``, ``depth_head.scratch.refinenet{i}``, ...) and
its layout: ``pretrained.pos_embed`` keeps the cls position at row 0, which
the forward adds to the cls token (the JAX package folds it in at
conversion).  ``load_dav2_state_dict`` takes a released
``depth_anything_v2_vit{s,b,l}.pth`` strictly, but for DINOv2's
``mask_token`` (masked pre-training only) and the four
``refinenet4.resConfUnit1`` tensors, which no path uses (refinenet4 has no
skip input).  ``state_dict_from_flax`` carries a JAX params tree across,
with a zero cls position and ConvTranspose kernels un-flipped.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from artdeco_tpu_torch.device import float32_policy, resolve
from artdeco_tpu_torch.models.mast3r import ResidualConvUnit, layer_norm
from artdeco_tpu_torch.models.pi3 import (LN_EPS, POS_GRID, BlockRope, _PatchEmbed,
                                          read_state_dict, resize_pos_embed)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IGNORED_KEYS = ("pretrained.mask_token",) + tuple(
    f"depth_head.scratch.refinenet4.resConfUnit1.conv{i}.{k}"
    for i in (1, 2) for k in ("weight", "bias"))


@dataclasses.dataclass(frozen=True)
class DAV2Config:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale: float = 1.0
    features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    layer_ids: Sequence[int] = (4, 11, 17, 23)


def dav2_config(encoder: str = "vitl", **kw) -> DAV2Config:
    """The released sizes (the reference's ``model_configs``)."""
    if encoder == "vits":
        return DAV2Config(embed_dim=384, depth=12, num_heads=6, features=64,
                          out_channels=(48, 96, 192, 384), layer_ids=(2, 5, 8, 11), **kw)
    if encoder == "vitb":
        return DAV2Config(embed_dim=768, depth=12, num_heads=12, features=128,
                          out_channels=(96, 192, 384, 768), layer_ids=(2, 5, 8, 11), **kw)
    if encoder == "vitl":
        return DAV2Config(**kw)
    raise ValueError(encoder)


def tiny_dav2_config(**kw) -> DAV2Config:
    return DAV2Config(embed_dim=64, depth=4, num_heads=4, features=32,
                      out_channels=(16, 24, 32, 48), layer_ids=(0, 1, 2, 3), **kw)


def _resize_ac(x, oh: int, ow: int):
    """Bilinear resampling of NCHW with align_corners=True (the JAX
    package's gather form, ``_resize_bilinear_ac``)."""

    def axis(a, dim, out_n):
        size = a.shape[dim]
        pos = torch.linspace(0.0, size - 1.0, out_n, device=a.device)
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, size - 1)
        hi = torch.clamp(lo + 1, 0, size - 1)
        t = pos - lo
        shape = [1] * a.ndim
        shape[dim] = -1
        t = t.reshape(shape)
        return a.index_select(dim, lo) * (1 - t) + a.index_select(dim, hi) * t

    return axis(axis(x, 2, oh), 3, ow)


class DinoV2(nn.Module):
    """DINOv2 without registers: returns the hooked layers' patch tokens
    through the final LayerNorm, float32."""

    def __init__(self, c: DAV2Config):
        super().__init__()
        self.cfg = c
        self.patch_embed = _PatchEmbed(c.patch_size, c.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + POS_GRID * POS_GRID, c.embed_dim))
        self.blocks = nn.ModuleList([
            BlockRope(c.embed_dim, c.num_heads, c.mlp_ratio, 100.0, torch.float32,
                      layerscale=c.layerscale, use_rope=False)
            for _ in range(c.depth)])
        self.norm = nn.LayerNorm(c.embed_dim, eps=LN_EPS)

    def forward(self, img):
        c = self.cfg
        b, _, h, w = img.shape
        nh, nw = h // c.patch_size, w // c.patch_size
        x = self.patch_embed.proj(img).flatten(2).transpose(1, 2)
        x = x + resize_pos_embed(self.pos_embed[:, 1:], nh, nw)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, -1, -1)
        toks = torch.cat([cls, x], dim=1)
        hooks = []
        for i, blk in enumerate(self.blocks):
            toks = blk(toks)
            if i in c.layer_ids:
                hooks.append(layer_norm(self.norm, toks, torch.float32)[:, 1:])
        return hooks, (nh, nw)


class FusionBlock(nn.Module):
    """DPT feature fusion: (skip through resConfUnit1) + x -> resConfUnit2
    -> align-corners resize (to ``size``, else x2) -> 1x1 out_conv."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        oh, ow = size if size is not None else (2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(_resize_ac(x, oh, ow))


class _Scratch(nn.Module):
    def __init__(self, c: DAV2Config):
        super().__init__()
        f = c.features
        for i, d in enumerate(c.out_channels, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(d, f, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i}", FusionBlock(f, with_skip=i != 4))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    def __init__(self, c: DAV2Config):
        super().__init__()
        oc = c.out_channels
        self.patch_size = c.patch_size
        self.projects = nn.ModuleList([nn.Conv2d(c.embed_dim, o, 1) for o in oc])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(c)

    def forward(self, hooks, nh: int, nw: int):
        layers = []
        for t, proj, resize in zip(hooks, self.projects, self.resize_layers):
            x = t.transpose(1, 2).reshape(t.shape[0], t.shape[-1], nh, nw)
            layers.append(resize(proj(x)))
        s = self.scratch
        r1, r2, r3, r4 = (getattr(s, f"layer{i}_rn")(x) for i, x in enumerate(layers, 1))
        p4 = s.refinenet4(r4, size=r3.shape[-2:])
        p3 = s.refinenet3(p4, r3, size=r2.shape[-2:])
        p2 = s.refinenet2(p3, r2, size=r1.shape[-2:])
        p1 = s.refinenet1(p2, r1)
        x = s.output_conv1(p1)
        x = _resize_ac(x, nh * self.patch_size, nw * self.patch_size)
        return s.output_conv2(x)[:, 0]


class DepthAnythingV2(nn.Module):
    """(B, 3, H, W) ImageNet-normalised -> (B, H, W) relative inverse depth."""

    def __init__(self, cfg: DAV2Config = DAV2Config()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoV2(cfg)
        self.depth_head = DPTHead(cfg)

    def forward(self, img):
        hooks, (nh, nw) = self.pretrained(img)
        return self.depth_head(hooks, nh, nw)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def load_dav2_state_dict(model: DepthAnythingV2, sd: dict) -> DepthAnythingV2:
    """Load a released state dict strictly, but for ``IGNORED_KEYS``."""
    sd = {k: (v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v)))
          for k, v in sd.items() if k not in IGNORED_KEYS}
    model.load_state_dict(sd, strict=True)
    return model


def random_dav2(cfg: DAV2Config, generator: torch.Generator, device) -> DepthAnythingV2:
    """A model on ``device`` with seeded random weights drawn there:
    normal(0, 0.02) weights, biases and tokens, unit LayerNorms, LayerScale
    at its configured value."""
    with torch.device("meta"):
        model = DepthAnythingV2(cfg)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            owner = name.split(".")[-2] if "." in name else ""
            if owner.startswith("norm"):
                prm.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(".gamma"):
                prm.fill_(cfg.layerscale)
            else:
                prm.copy_(torch.randn(prm.shape, generator=generator, device=device) * 0.02)
    return model


def state_dict_from_flax(params: dict, cfg: DAV2Config) -> dict:
    """A JAX package params tree -> the release-layout state dict (numpy):
    the inverse of ``convert_dav2_state_dict``, with the cls position row
    at zero (the flax cls token has it folded in) and the ConvTranspose
    kernels flipped back.  The four dead ``refinenet4.resConfUnit1``
    tensors have no flax leaf and are left out."""
    p = params.get("params", params)
    a = np.asarray
    sd = {}

    def dense(name, t):
        sd[f"{name}.weight"] = a(t["kernel"], np.float32).T.copy()
        sd[f"{name}.bias"] = a(t["bias"], np.float32).copy()

    def ln(name, t):
        sd[f"{name}.weight"] = a(t["scale"], np.float32).copy()
        sd[f"{name}.bias"] = a(t["bias"], np.float32).copy()

    def conv(name, t):
        sd[f"{name}.weight"] = np.ascontiguousarray(a(t["kernel"], np.float32)
                                                    .transpose(3, 2, 0, 1))
        if "bias" in t:
            sd[f"{name}.bias"] = a(t["bias"], np.float32).copy()

    def deconv(name, t):
        w = a(t["kernel"], np.float32).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[f"{name}.weight"] = np.ascontiguousarray(w)
        sd[f"{name}.bias"] = a(t["bias"], np.float32).copy()

    enc = p["encoder"]
    conv("pretrained.patch_embed.proj", enc["patch_embed"])
    cls = a(enc["cls_token"], np.float32)
    sd["pretrained.cls_token"] = cls.copy()
    sd["pretrained.pos_embed"] = np.concatenate(
        [np.zeros_like(cls), a(enc["pos_embed"], np.float32)], axis=1)
    ln("pretrained.norm", enc["norm"])
    for i in range(cfg.depth):
        b, t = f"pretrained.blocks.{i}", enc[f"block_{i}"]
        ln(f"{b}.norm1", t["norm1"])
        ln(f"{b}.norm2", t["norm2"])
        dense(f"{b}.attn.qkv", t["attn"]["qkv"])
        dense(f"{b}.attn.proj", t["attn"]["proj"])
        dense(f"{b}.mlp.fc1", t["mlp_fc1"])
        dense(f"{b}.mlp.fc2", t["mlp_fc2"])
        sd[f"{b}.ls1.gamma"] = a(t["ls1"]["gamma"], np.float32).copy()
        sd[f"{b}.ls2.gamma"] = a(t["ls2"]["gamma"], np.float32).copy()
    h = "depth_head"
    for i in range(4):
        conv(f"{h}.projects.{i}", p[f"project{i + 1}"])
    deconv(f"{h}.resize_layers.0", p["resize1"])
    deconv(f"{h}.resize_layers.1", p["resize2"])
    conv(f"{h}.resize_layers.3", p["resize4"])
    for i in range(1, 5):
        conv(f"{h}.scratch.layer{i}_rn", p[f"layer{i}_rn"])
        rf, t = f"{h}.scratch.refinenet{i}", p[f"refinenet{i}"]
        for unit, key in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
            if key in t:
                conv(f"{rf}.{unit}.conv1", t[key]["conv1"])
                conv(f"{rf}.{unit}.conv2", t[key]["conv2"])
        conv(f"{rf}.out_conv", t["out_conv"])
    conv(f"{h}.scratch.output_conv1", p["output_conv1"])
    conv(f"{h}.scratch.output_conv2.0", p["output_conv2_0"])
    conv(f"{h}.scratch.output_conv2.2", p["output_conv2_2"])
    return sd


def _resize_linear(x, size):
    """``jax.image.resize(..., "bilinear")`` of NCHW: half-pixel centres,
    antialiased where it shrinks."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size, mode="bilinear", align_corners=False, antialias=True)


def make_dav2_model_fn(checkpoint_path: str = "", encoder: str = "vitl", size: int = 518,
                       *, device=None, seed: int = 0):
    """``model_fn(img_chw in [0, 1]) -> idepth (H, W)`` (numpy) for
    ``mapper.mono_depth.MonoDepthEstimator``: resize to ``size`` on the
    long side in patch multiples (392x518 for a 512x384 frame), ImageNet
    normalisation, the forward on ``device`` (None: the CUDA device), and
    the resize back.  Weights from a ``.pth`` / ``.safetensors``
    checkpoint, else random, drawn on ``device`` from a generator seeded by
    ``seed``."""
    device = resolve(device)
    if device.type == "cuda":
        float32_policy()
    cfg = dav2_config(encoder)
    if checkpoint_path:
        model = load_dav2_state_dict(DepthAnythingV2(cfg), read_state_dict(checkpoint_path))
    else:
        model = random_dav2(cfg, torch.Generator(device=device).manual_seed(seed), device)
    model = model.to(device).eval()
    mean = torch.tensor(IMAGENET_MEAN, device=device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).reshape(1, 3, 1, 1)

    @torch.no_grad()
    def model_fn(img_chw):
        _, h, w = img_chw.shape
        s = size / max(h, w)
        p = cfg.patch_size
        nh = max(int(round(h * s / p)), 1) * p
        nw = max(int(round(w * s / p)), 1) * p
        x = torch.as_tensor(img_chw, dtype=torch.float32, device=device)[None]
        x = (_resize_linear(x, (nh, nw)) - mean) / std
        d = model(x)
        return _resize_linear(d[:, None], (h, w))[0, 0].cpu().numpy()

    model_fn.model = model
    return model_fn
