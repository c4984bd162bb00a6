"""Pi3 multi-view pointmap network in PyTorch.

Port of ``artdeco_tpu/models/pi3.py`` (the reference's Pi3): a DINOv2
ViT-L/14 encoder (cls and 4 register tokens, LayerScale), a 36-block RoPE
decoder that alternates frame-local and global attention (5 register
tokens, qk-norm, LayerScale 0.01), and three transformer heads: local
points (xy*z, exp z), confidence, and a per-frame pose whose 9-D rotation
is orthogonalised by an SVD; world points by unprojection.  The
accurate-loop-closure path runs it jointly over <= 24 keyframes at
392x518 (``vslam/accurate_lc.py``).

The modules carry the released checkpoint's names (``encoder.blocks.{i}``,
``decoder.{i}.attn.q_norm``, ``point_decoder.projects``,
``camera_head.res_conv.{i}.res_conv{j}``, ...) and its layout: the
encoder's ``pos_embed`` holds the cls position at row 0, which the forward
adds to the cls token (the JAX package folds it in at conversion).  So
``load_pi3_state_dict`` takes a released dict as it is, strictly (DINOv2's
``encoder.mask_token``, used only in masked pre-training, is dropped), and
``state_dict_from_flax`` carries a JAX params tree across with a zero cls
position.

Dtypes follow the JAX package: with ``compute_dtype`` bfloat16 the patch
embedding and the blocks' linear layers hold bf16 weights; LayerNorms run
in float32; LayerScale's float32 ``gamma`` promotes a block's bf16 branch,
so the encoder's and decoder's residual streams are float32 after their
first block, while the heads' blocks (no LayerScale) keep a bf16 stream;
the heads' output layers, the pixel-shuffle heads and the camera head run
in float32.

The position embedding is resized from its 37x37 grid as
``jax.image.resize(..., "cubic")`` does it (``cubic_resize_matrix``): Keys
cubic with a = -0.5, half-pixel centres, the kernel widened when
downsampling (antialiasing); ``F.interpolate``'s bicubic (a = -0.75, no
antialiasing) is another filter.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.models.mast3r import attention, layer_norm, rope2d

LN_EPS = 1e-6
POS_GRID = 37                    # 518 / 14: the pretrained position grid
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
IGNORED_KEYS = ("encoder.mask_token",)


@dataclasses.dataclass(frozen=True)
class Pi3Config:
    patch_size: int = 14
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    enc_registers: int = 4
    dec_embed_dim: int = 1024
    dec_depth: int = 36
    dec_num_heads: int = 16
    dec_registers: int = 5
    head_dim: int = 1024
    head_depth: int = 5
    head_num_heads: int = 16
    camera_dim: int = 512
    mlp_ratio: float = 4.0
    rope_freq: float = 100.0
    layerscale_enc: float = 1.0
    layerscale_dec: float = 0.01
    compute_dtype: torch.dtype = torch.bfloat16


def tiny_pi3_config(**kw) -> Pi3Config:
    return Pi3Config(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
        dec_embed_dim=64, dec_depth=4, dec_num_heads=4,
        head_dim=64, head_depth=2, head_num_heads=4, camera_dim=32, **kw,
    )


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s "cubic"
    along one axis (``jax._src.image.scale.compute_weight_mat`` with the
    Keys kernel, antialiased), computed in float32 as JAX computes them.
    An axis whose size does not change is not resampled (identity)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    w = np.where(x >= 2.0, f32(0.0), out).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_pos_embed(pos: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(1, 37*37, C) patch position embedding -> (1, nh*nw, C)."""
    c = pos.shape[-1]
    grid = pos.reshape(POS_GRID, POS_GRID, c)
    wh = torch.as_tensor(cubic_resize_matrix(POS_GRID, nh), device=pos.device)
    ww = torch.as_tensor(cubic_resize_matrix(POS_GRID, nw), device=pos.device)
    out = torch.einsum("hwc,hy,wx->yxc", grid.float(), wh, ww)
    return out.reshape(1, nh * nw, c)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma


class RopeAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, rope_freq: float, qk_norm: bool = False,
                 use_rope: bool = True):
        super().__init__()
        self.num_heads, self.rope_freq, self.use_rope = num_heads, rope_freq, use_rope
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // num_heads, eps=LN_EPS)
            self.k_norm = nn.LayerNorm(dim // num_heads, eps=LN_EPS)
        self.qk_norm = qk_norm
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, xpos):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        if self.qk_norm:
            q = layer_norm(self.q_norm, q, x.dtype)
            k = layer_norm(self.k_norm, k, x.dtype)
        if self.use_rope and xpos is not None:
            q = rope2d(q, xpos, self.rope_freq)
            k = rope2d(k, xpos, self.rope_freq)
        return self.proj(attention(q, k, v))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class BlockRope(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, rope_freq: float,
                 dtype: torch.dtype, layerscale=None, qk_norm: bool = False,
                 use_rope: bool = True):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = RopeAttention(dim, num_heads, rope_freq, qk_norm, use_rope)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layerscale is not None:
            self.ls1 = LayerScale(dim, layerscale)
            self.ls2 = LayerScale(dim, layerscale)
        self.layerscale = layerscale is not None

    def forward(self, x, xpos=None):
        h = self.attn(layer_norm(self.norm1, x, self.dtype), xpos)
        x = x + (self.ls1(h) if self.layerscale else h)
        h = self.mlp(layer_norm(self.norm2, x, self.dtype))
        return x + (self.ls2(h) if self.layerscale else h)


class _PatchEmbed(nn.Module):
    def __init__(self, p: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, p, stride=p)


class DinoV2Encoder(nn.Module):
    """DINOv2 with registers: returns the normalised patch tokens, float32."""

    def __init__(self, cfg: Pi3Config):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = _PatchEmbed(c.patch_size, c.enc_embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.enc_embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, c.enc_registers, c.enc_embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + POS_GRID * POS_GRID, c.enc_embed_dim))
        self.blocks = nn.ModuleList([
            BlockRope(c.enc_embed_dim, c.enc_num_heads, c.mlp_ratio, c.rope_freq,
                      c.compute_dtype, layerscale=c.layerscale_enc, use_rope=False)
            for _ in range(c.enc_depth)])
        self.norm = nn.LayerNorm(c.enc_embed_dim, eps=LN_EPS)

    def forward(self, img):
        c = self.cfg
        b, _, h, w = img.shape
        nh, nw = h // c.patch_size, w // c.patch_size
        dt = c.compute_dtype
        x = self.patch_embed.proj(img.to(dt)).flatten(2).transpose(1, 2)
        x = x + resize_pos_embed(self.pos_embed[:, 1:], nh, nw).to(dt)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(dt).expand(b, -1, -1)
        reg = self.register_tokens.to(dt).expand(b, -1, -1)
        toks = torch.cat([cls, reg, x], dim=1)
        for blk in self.blocks:
            toks = blk(toks)
        return layer_norm(self.norm, toks, torch.float32)[:, 1 + c.enc_registers:]


class TransformerHead(nn.Module):
    """project -> depth x BlockRope -> linear out (float32)."""

    def __init__(self, cfg: Pi3Config, out_dim: int):
        super().__init__()
        c = cfg
        self.dtype = c.compute_dtype
        self.projects = nn.Linear(2 * c.dec_embed_dim, c.head_dim)
        self.blocks = nn.ModuleList([
            BlockRope(c.head_dim, c.head_num_heads, c.mlp_ratio, c.rope_freq, c.compute_dtype)
            for _ in range(c.head_depth)])
        self.linear_out = nn.Linear(c.head_dim, out_dim)

    def forward(self, hidden, xpos):
        x = self.projects(hidden.to(self.dtype))
        for blk in self.blocks:
            x = blk(x, xpos)
        return self.linear_out(x.float())


class _Proj(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = nn.Linear(dim, out)


class _ResConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.res_conv1 = nn.Linear(dim, dim)
        self.res_conv2 = nn.Linear(dim, dim)
        self.res_conv3 = nn.Linear(dim, dim)

    def forward(self, x):
        y = F.relu(self.res_conv1(x))
        y = F.relu(self.res_conv2(y))
        return x + F.relu(self.res_conv3(y))


class CameraHead(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.res_conv = nn.ModuleList([_ResConv(dim), _ResConv(dim)])
        self.more_mlps = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim),
                                       nn.ReLU())
        self.fc_t = nn.Linear(dim, 3)
        self.fc_rot = nn.Linear(dim, 9)

    def forward(self, feat):
        for rc in self.res_conv:
            feat = rc(feat)
        m = self.more_mlps(feat.mean(dim=1))
        return self.fc_t(m), self.fc_rot(m).reshape(-1, 3, 3)


def svd_orthogonalize(m: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3) -> rotations: rows normalised first, then the SVD of the
    transpose m^T = u s v^T and R = v diag(1, 1, det(v u^T)) u^T.  A sign
    flip of a singular pair flips the matching columns of u and v alike,
    so R does not depend on the SVD's sign choices."""
    mn = m.float()
    mn = mn / torch.sqrt(torch.sum(mn * mn, dim=-1, keepdim=True) + 1e-24)
    u, _, vh = torch.linalg.svd(mn.transpose(-1, -2))
    v, ut = vh.transpose(-1, -2), u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (v * d[:, None, :]) @ ut


class Pi3(nn.Module):
    def __init__(self, cfg: Pi3Config = Pi3Config()):
        super().__init__()
        c = self.cfg = cfg
        if c.enc_embed_dim != c.dec_embed_dim:
            raise ValueError("Pi3: encoder and decoder widths must be equal (no enc2dec)")
        self.encoder = DinoV2Encoder(c)
        self.register_token = nn.Parameter(torch.zeros(1, 1, c.dec_registers, c.dec_embed_dim))
        self.decoder = nn.ModuleList([
            BlockRope(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio, c.rope_freq,
                      c.compute_dtype, layerscale=c.layerscale_dec, qk_norm=True)
            for _ in range(c.dec_depth)])
        self.point_decoder = TransformerHead(c, c.head_dim)
        self.conf_decoder = TransformerHead(c, c.head_dim)
        self.camera_decoder = TransformerHead(c, c.camera_dim)
        p = c.patch_size
        self.point_head = _Proj(c.head_dim, 3 * p * p)
        self.conf_head = _Proj(c.head_dim, p * p)
        self.camera_head = CameraHead(c.camera_dim)
        self.register_buffer("mean", torch.tensor(_MEAN).reshape(1, 1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_STD).reshape(1, 1, 3, 1, 1), persistent=False)
        self.set_compute_dtype()

    def set_compute_dtype(self):
        """The patch embedding and every block's linear layers (and the
        heads' input projections) in ``cfg.compute_dtype``."""
        dt = self.cfg.compute_dtype
        self.encoder.patch_embed.to(dt)
        heads = (self.point_decoder, self.conf_decoder, self.camera_decoder)
        for blk in (*self.encoder.blocks, *self.decoder, *(b for h in heads for b in h.blocks)):
            for m in blk.modules():
                if isinstance(m, nn.Linear):
                    m.to(dt)
        for h in heads:
            h.projects.to(dt)
        return self

    def forward(self, imgs):
        """imgs (B, N, 3, H, W) in [0, 1] -> dict(points, local_points,
        conf, camera_poses)."""
        c = self.cfg
        imgs = (imgs.float() - self.mean) / self.std
        B, N, _, H, W = imgs.shape
        p = c.patch_size
        nh, nw = H // p, W // p
        hidden = self.encoder(imgs.reshape(B * N, 3, H, W))
        r = c.dec_registers
        reg = self.register_token.expand(B, N, r, -1).reshape(B * N, r, -1)
        hidden = torch.cat([reg, hidden], dim=1)
        hw = hidden.shape[1]
        dev = imgs.device
        ys, xs = torch.meshgrid(torch.arange(nh, device=dev) + 1,
                                torch.arange(nw, device=dev) + 1, indexing="ij")
        pos = torch.cat([torch.zeros(r, 2, dtype=torch.int64, device=dev),
                         torch.stack([ys, xs], -1).reshape(nh * nw, 2)])
        pos = pos[None].expand(B * N, hw, 2)

        outputs = []
        x = hidden
        for i, blk in enumerate(self.decoder):
            if i % 2 == 0:       # within each frame
                x = blk(x.reshape(B * N, hw, -1), pos)
            else:                # across all frames
                x = blk(x.reshape(B, N * hw, -1), pos.reshape(B, N * hw, 2))
            x = x.reshape(B * N, hw, -1)
            if i + 1 in (c.dec_depth - 1, c.dec_depth):
                outputs.append(x)
        hidden2 = torch.cat(outputs, dim=-1)
        point_h = self.point_decoder(hidden2, pos)
        conf_h = self.conf_decoder(hidden2, pos)
        cam_h = self.camera_decoder(hidden2, pos)

        def pts_head(h, head):
            y = head.proj(h[:, r:])
            y = y.reshape(B * N, nh, nw, -1, p, p).permute(0, 1, 4, 2, 5, 3)
            return y.reshape(B, N, H, W, -1)

        ret = pts_head(point_h, self.point_head)
        z = torch.exp(ret[..., 2:3])
        local_points = torch.cat([ret[..., :2] * z, z], dim=-1)
        conf = pts_head(conf_h, self.conf_head)

        out_t, out_r = self.camera_head(cam_h[:, r:])
        R = svd_orthogonalize(out_r)
        pose = torch.zeros(B * N, 4, 4, device=dev)
        pose[:, :3, :3] = R
        pose[:, :3, 3] = out_t
        pose[:, 3, 3] = 1.0
        camera_poses = pose.reshape(B, N, 4, 4)
        Rp, tp = camera_poses[..., :3, :3], camera_poses[..., :3, 3]
        points = torch.einsum("bnij,bnhwj->bnhwi", Rp, local_points) + tp[:, :, None, None, :]
        return dict(points=points, local_points=local_points, conf=conf,
                    camera_poses=camera_poses)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def load_pi3_state_dict(model: Pi3, sd: dict) -> Pi3:
    """Load a released (or ``convert_pi3.synth_pi3_state_dict``) state dict
    strictly, but for ``IGNORED_KEYS``."""
    sd = {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
          for k, v in sd.items() if k not in IGNORED_KEYS}
    model.load_state_dict(sd, strict=True)
    return model


def empty_pi3(cfg: Pi3Config, device) -> Pi3:
    """A model whose (uninitialised) weights are allocated on ``device``
    only, to be filled by ``load_pi3_state_dict`` or ``random_pi3``."""
    with torch.device("meta"):
        model = Pi3(cfg)
    model = model.to_empty(device=device)
    with torch.no_grad():
        model.mean.copy_(torch.tensor(_MEAN).reshape(1, 1, 3, 1, 1))
        model.std.copy_(torch.tensor(_STD).reshape(1, 1, 3, 1, 1))
    return model


def random_pi3(cfg: Pi3Config, generator: torch.Generator, device) -> Pi3:
    """A model on ``device`` with seeded random weights drawn there:
    normal(0, 0.02) weights, biases and tokens, unit LayerNorms, LayerScale
    at its configured value, register tokens at normal(0, 1e-6)."""
    model = empty_pi3(cfg, device)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            owner = name.split(".")[-2] if "." in name else ""
            if owner.startswith("norm") or owner.endswith("_norm"):
                prm.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(".gamma"):
                prm.fill_(cfg.layerscale_enc if name.startswith("encoder.")
                          else cfg.layerscale_dec)
            else:
                std = 1e-6 if name == "register_token" else 0.02
                prm.copy_(torch.randn(prm.shape, generator=generator, device=device) * std)
    return model


def state_dict_from_flax(params: dict, cfg: Pi3Config = Pi3Config()) -> dict:
    """A JAX package params tree -> the release-layout state dict (numpy):
    the inverse of ``convert_pi3.convert_pi3_state_dict``, with the cls
    position row at zero (the flax cls token has it folded in)."""
    p = params.get("params", params)
    a = np.asarray
    sd = {}

    def dense(name, t):
        sd[f"{name}.weight"] = a(t["kernel"], np.float32).T.copy()
        sd[f"{name}.bias"] = a(t["bias"], np.float32).copy()

    def ln(name, t):
        sd[f"{name}.weight"] = a(t["scale"], np.float32).copy()
        sd[f"{name}.bias"] = a(t["bias"], np.float32).copy()

    def block(name, t):
        ln(f"{name}.norm1", t["norm1"])
        ln(f"{name}.norm2", t["norm2"])
        dense(f"{name}.attn.qkv", t["attn"]["qkv"])
        dense(f"{name}.attn.proj", t["attn"]["proj"])
        for k in ("q_norm", "k_norm"):
            if k in t["attn"]:
                ln(f"{name}.attn.{k}", t["attn"][k])
        dense(f"{name}.mlp.fc1", t["mlp_fc1"])
        dense(f"{name}.mlp.fc2", t["mlp_fc2"])
        for k in ("ls1", "ls2"):
            if k in t:
                sd[f"{name}.{k}.gamma"] = a(t[k]["gamma"], np.float32).copy()

    enc = p["encoder"]
    sd["encoder.patch_embed.proj.weight"] = np.ascontiguousarray(
        a(enc["patch_embed"]["kernel"], np.float32).transpose(3, 2, 0, 1))
    sd["encoder.patch_embed.proj.bias"] = a(enc["patch_embed"]["bias"], np.float32).copy()
    cls = a(enc["cls_token"], np.float32)
    sd["encoder.cls_token"] = cls.copy()
    sd["encoder.register_tokens"] = a(enc["register_tokens"], np.float32).copy()
    sd["encoder.pos_embed"] = np.concatenate(
        [np.zeros_like(cls), a(enc["pos_embed"], np.float32)], axis=1)
    ln("encoder.norm", enc["norm"])
    for i in range(cfg.enc_depth):
        block(f"encoder.blocks.{i}", enc[f"block_{i}"])
    sd["register_token"] = a(p["register_token"], np.float32).copy()
    for i in range(cfg.dec_depth):
        block(f"decoder.{i}", p[f"dec_block_{i}"])
    for head in ("point_decoder", "conf_decoder", "camera_decoder"):
        t = p[head]
        dense(f"{head}.projects", t["project"])
        dense(f"{head}.linear_out", t["linear_out"])
        for i in range(cfg.head_depth):
            block(f"{head}.blocks.{i}", t[f"block_{i}"])
    dense("point_head.proj", p["point_head"])
    dense("conf_head.proj", p["conf_head"])
    dense("camera_head.more_mlps.0", p["cam_mlp1"])
    dense("camera_head.more_mlps.2", p["cam_mlp2"])
    dense("camera_head.fc_t", p["fc_t"])
    dense("camera_head.fc_rot", p["fc_rot"])
    for i in range(2):
        for j in (1, 2, 3):
            dense(f"camera_head.res_conv.{i}.res_conv{j}", p[f"cam_res{i}_{j}"])
    return sd


def _read_state_dict(path: str) -> dict:
    """A checkpoint's state dict: ``.safetensors`` through ``safetensors``
    (raises when the package is missing), else ``torch.load``."""
    if path.endswith(".npz"):
        raise NotImplementedError("flax .npz checkpoints are not ported: pass the released "
                                  ".safetensors or .pth file")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("model", ckpt)


def load_pi3_apply(checkpoint_path: str = "", full: bool = True, state_dict: dict = None,
                   seed: int = 0, *, device=None, generator: torch.Generator = None):
    """``(apply, resize_hw)``: ``apply(imgs (1, N, 3, H, W) in [0, 1]) ->
    dict`` of the Pi3 forward on ``device``, and the joint-inference
    resolution (392x518 at full size).  Weights from ``state_dict``, else
    from ``checkpoint_path`` when the file exists, else random (tiny config
    unless ``full``) with a warning, as in the JAX package."""
    device = resolve(device)
    cfg = Pi3Config() if full else tiny_pi3_config()
    resize_hw = (392, 518) if full else (112, 140)
    if state_dict is None and checkpoint_path and os.path.isfile(checkpoint_path):
        state_dict = _read_state_dict(checkpoint_path)
        print(f"loaded Pi3 weights from {checkpoint_path}")
    if state_dict is not None:
        model = load_pi3_state_dict(empty_pi3(cfg, device), state_dict)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        model = random_pi3(cfg, generator, device)
        print("WARNING: no Pi3 checkpoint; accurate loop closure runs with "
              "random weights (verification will be meaningless)")
    model = model.to(device).eval()

    @torch.no_grad()
    def apply(imgs):
        return model(torch.as_tensor(imgs, device=device))

    apply.model = model
    return apply, resize_hw
