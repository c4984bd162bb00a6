"""Plain float32 Pi3: the reference the Pi3 cell is judged against.

A frozen copy of the published architecture (pi^3, "Scalable
Permutation-Equivariant Visual Geometry Learning", arXiv:2507.13347; the
``Pi3`` of https://github.com/yyfz/Pi3, released at
https://huggingface.co/yyfz233/Pi3): a DINOv2 ViT-L/14 encoder with a cls
token, 4 registers and LayerScale; a 36-block RoPE decoder whose even
blocks attend within each frame and odd blocks across all frames, with 5
register tokens, qk-norm and LayerScale; three transformer heads (local
points as xy*z, exp z; confidence; a per-frame camera whose 9-D rotation is
orthogonalised by an SVD); world points by unprojection.  Written for this
benchmark in plain PyTorch: float32 throughout, attention as two matmuls
and a softmax, head by head and in blocks of ``QUERY_BLOCK`` queries (the
scores of one head over the 24,984 tokens of a 24-frame global block are
2.5 GB in float32), no fused kernel.  It imports nothing of the measured
program.  The parameter names are the released checkpoint's
(``encoder.blocks.{i}.ls1.gamma``, ``decoder.{i}.attn.q_norm``,
``point_decoder.projects``, ``camera_head.res_conv.{i}.res_conv{j}``, ...),
so one state dict loads both this model and the program's.

Departures from the published model:

- The patch position embedding is resized from its 37x37 grid with the
  Keys cubic filter (a = -0.5, half-pixel centres, the kernel widened when
  shrinking, each output normalised), as the measured system resizes it
  (``jax.image.resize(..., "cubic")``); DINOv2's ``interpolate_pos_encoding``
  calls ``F.interpolate(mode="bicubic")`` (a = -0.75) on a scale factor
  offset by 0.1.  An axis whose size does not change is not resampled.
  The resize runs on the host in float64.
- DINOv2's ``mask_token`` (used only in masked pre-training) is not held.
- Rotary embedding (CroCo's RoPE2D, frequency 100) rotates in float32.

``trunk_quant="fp8"`` is the control: every linear layer of the encoder
and decoder blocks, the heads' input projections and blocks, and the patch
convolution (the layers the configuration runs in bfloat16) take their
operands rounded to float8 e4m3 with one scale per tensor, the precision
below the program's bfloat16 trunk.  Norms, attention products, the heads'
output layers and the camera head stay float32.

Callers turn TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``
and ``torch.backends.cudnn.allow_tf32 = False``) before they run it on a
card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.mast3r_plain import LN_EPS, QConv2d, QLinear, rope2d

QUERY_BLOCK = 2048
POS_GRID = 37                    # 518 / 14: the pretrained position grid
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Widths:
    """The architecture's sizes (the configuration file holds the published
    ones)."""
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


def widths_from(cfg: dict) -> Widths:
    keys = {f.name for f in dataclasses.fields(Widths)}
    return Widths(**{k: v for k, v in cfg.items() if k in keys})


def attention(q, k, v, block: int = QUERY_BLOCK):
    """softmax(q k^T / sqrt(d)) v over (B, heads, N, D) -> (B, N, heads*D),
    one head and ``block`` queries at a time."""
    b, h, n, d = q.shape
    out = q.new_empty(b, n, h, d)
    scale = d ** -0.5
    for j in range(h):
        kt = k[:, j].transpose(-1, -2)
        for s in range(0, n, block):
            sc = torch.matmul(q[:, j, s:s + block], kt) * scale
            out[:, s:s + block, j] = torch.matmul(torch.softmax(sc, dim=-1), v[:, j])
    return out.reshape(b, n, h * d)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 weights of the Keys cubic (a = -0.5) resize
    along one axis: half-pixel centres, the kernel widened by the scale when
    shrinking, each output's weights normalised to sum 1, zero for outputs
    whose centre lies outside the input; the identity when the size does
    not change."""
    if n_in == n_out:
        return np.eye(n_in)
    scale = n_out / n_in
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(1.0 / scale, 1.0)
    w = np.where(x < 1.0, ((1.5 * x - 2.5) * x) * x + 1.0,
                 np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_pos_embed(pos: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(1, 37*37, C) patch position embedding -> (1, nh*nw, C), float32."""
    c = pos.shape[-1]
    grid = pos.detach().reshape(POS_GRID, POS_GRID, c).cpu().double().numpy()
    out = np.einsum("hwc,hy,wx->yxc", grid, cubic_weights(POS_GRID, nh),
                    cubic_weights(POS_GRID, nw))
    return torch.as_tensor(out.reshape(1, nh * nw, c), dtype=torch.float32,
                           device=pos.device)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, rope_freq, qk_norm, use_rope):
        super().__init__()
        self.num_heads, self.rope_freq, self.use_rope = num_heads, rope_freq, use_rope
        self.qkv = QLinear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // num_heads, eps=LN_EPS)
            self.k_norm = nn.LayerNorm(dim // num_heads, eps=LN_EPS)
        self.qk_norm = qk_norm
        self.proj = QLinear(dim, dim)

    def forward(self, x, xpos):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads).permute(
            2, 0, 3, 1, 4)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.use_rope:
            q, k = rope2d(q, xpos, self.rope_freq), rope2d(k, xpos, self.rope_freq)
        return self.proj(attention(q, k, v))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = QLinear(dim, hidden)
        self.fc2 = QLinear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    """Pre-norm attention and MLP, each branch optionally LayerScaled."""

    def __init__(self, dim, num_heads, mlp_ratio, rope_freq, layerscale=False, qk_norm=False,
                 use_rope=True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, rope_freq, qk_norm, use_rope)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layerscale:
            self.ls1, self.ls2 = LayerScale(dim), LayerScale(dim)
        self.layerscale = layerscale

    def forward(self, x, xpos=None):
        h = self.attn(self.norm1(x), xpos)
        x = x + (self.ls1(h) if self.layerscale else h)
        h = self.mlp(self.norm2(x))
        return x + (self.ls2(h) if self.layerscale else h)


class PatchEmbed(nn.Module):
    def __init__(self, p, dim):
        super().__init__()
        self.proj = QConv2d(3, dim, p, stride=p)


class Encoder(nn.Module):
    """DINOv2 with registers: the normalised patch tokens."""

    def __init__(self, c: Widths):
        super().__init__()
        C = c.enc_embed_dim
        self.patch_embed = PatchEmbed(c.patch_size, C)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.register_tokens = nn.Parameter(torch.zeros(1, c.enc_registers, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + POS_GRID * POS_GRID, C))
        self.blocks = nn.ModuleList([Block(C, c.enc_num_heads, c.mlp_ratio, c.rope_freq,
                                           layerscale=True, use_rope=False)
                                     for _ in range(c.enc_depth)])
        self.norm = nn.LayerNorm(C, eps=LN_EPS)

    def forward(self, img, pos_patches):
        b = img.shape[0]
        x = self.patch_embed.proj(img).flatten(2).transpose(1, 2) + pos_patches
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, -1, -1)
        reg = self.register_tokens.expand(b, -1, -1)
        x = torch.cat([cls, reg, x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.register_tokens.shape[1]:]


class TransformerHead(nn.Module):
    """project -> depth x Block -> linear out."""

    def __init__(self, c: Widths, out_dim: int):
        super().__init__()
        self.projects = QLinear(2 * c.dec_embed_dim, c.head_dim)
        self.blocks = nn.ModuleList([Block(c.head_dim, c.head_num_heads, c.mlp_ratio,
                                           c.rope_freq) for _ in range(c.head_depth)])
        self.linear_out = nn.Linear(c.head_dim, out_dim)

    def forward(self, x, xpos):
        x = self.projects(x)
        for blk in self.blocks:
            x = blk(x, xpos)
        return self.linear_out(x)


class Proj(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.proj = nn.Linear(dim, out)


class ResConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.res_conv1 = nn.Linear(dim, dim)
        self.res_conv2 = nn.Linear(dim, dim)
        self.res_conv3 = nn.Linear(dim, dim)

    def forward(self, x):
        y = F.relu(self.res_conv2(F.relu(self.res_conv1(x))))
        return x + F.relu(self.res_conv3(y))


def _mm3(a, b):
    """(n, 3, 3) @ (n, 3, 3) as elementwise products and a sum."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(dim=2)


def svd_orthogonalize(m):
    """(n, 3, 3) -> rotations: the rows normalised, the SVD u s v^T of the
    transpose, R = v diag(1, 1, det(v u^T)) u^T."""
    m = F.normalize(m, p=2, dim=-1)
    u, _, vh = torch.linalg.svd(m.transpose(1, 2))
    v, ut = vh.transpose(1, 2), u.transpose(1, 2)
    det = torch.linalg.det(_mm3(v, ut))
    v = torch.cat([v[:, :, :-1], v[:, :, -1:] * det[:, None, None]], dim=2)
    return _mm3(v, ut)


class CameraHead(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.res_conv = nn.ModuleList([ResConv(dim), ResConv(dim)])
        self.more_mlps = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim),
                                       nn.ReLU())
        self.fc_t = nn.Linear(dim, 3)
        self.fc_rot = nn.Linear(dim, 9)

    def forward(self, feat):
        """(n, tokens, dim) -> (rotations (n, 3, 3), translations (n, 3))."""
        for rc in self.res_conv:
            feat = rc(feat)
        m = self.more_mlps(feat.mean(dim=1))
        return svd_orthogonalize(self.fc_rot(m).reshape(-1, 3, 3)), self.fc_t(m)


class PlainPi3(nn.Module):
    def __init__(self, c: Widths = Widths()):
        super().__init__()
        self.c = c
        D = c.dec_embed_dim
        self.encoder = Encoder(c)
        self.register_token = nn.Parameter(torch.zeros(1, 1, c.dec_registers, D))
        self.decoder = nn.ModuleList([Block(D, c.dec_num_heads, c.mlp_ratio, c.rope_freq,
                                            layerscale=True, qk_norm=True)
                                      for _ in range(c.dec_depth)])
        self.point_decoder = TransformerHead(c, c.head_dim)
        self.conf_decoder = TransformerHead(c, c.head_dim)
        self.camera_decoder = TransformerHead(c, c.camera_dim)
        p = c.patch_size
        self.point_head = Proj(c.head_dim, 3 * p * p)
        self.conf_head = Proj(c.head_dim, p * p)
        self.camera_head = CameraHead(c.camera_dim)

    def set_trunk_quant(self, mode):
        """None: float32; "fp8": the trunk's operands rounded to float8."""
        if mode not in (None, "fp8"):
            raise ValueError(f"trunk_quant {mode!r}: None or 'fp8'")
        for m in self.modules():
            if isinstance(m, (QLinear, QConv2d)):
                m.quant = mode == "fp8"
        return self

    def decode(self, hidden, B, N, nh, nw):
        """(B*N, nh*nw, C) patch tokens -> the last two blocks' outputs
        concatenated (B*N, r + nh*nw, 2C) and their (y, x) positions,
        registers first (at position 0, the patches from 1)."""
        c, dev = self.c, hidden.device
        r = c.dec_registers
        reg = self.register_token.expand(B, N, r, -1).reshape(B * N, r, -1)
        x = torch.cat([reg, hidden], dim=1)
        hw = x.shape[1]
        ys, xs = torch.meshgrid(torch.arange(nh, device=dev) + 1,
                                torch.arange(nw, device=dev) + 1, indexing="ij")
        pos = torch.cat([torch.zeros(r, 2, dtype=torch.int64, device=dev),
                         torch.stack([ys, xs], -1).reshape(nh * nw, 2)])
        pos = pos[None].expand(B * N, hw, 2)
        outputs = []
        for i, blk in enumerate(self.decoder):
            if i % 2 == 0:       # within each frame
                x = blk(x.reshape(B * N, hw, -1), pos)
            else:                # across all the frames of a batch
                x = blk(x.reshape(B, N * hw, -1), pos.reshape(B, N * hw, 2))
            x = x.reshape(B * N, hw, -1)
            if i + 1 in (c.dec_depth - 1, c.dec_depth):
                outputs.append(x)
        return torch.cat(outputs, dim=-1), pos

    def forward(self, imgs):
        """imgs (B, N, 3, H, W) in [0, 1] -> dict(points, local_points, conf,
        camera_poses), float32."""
        c = self.c
        B, N, _, H, W = imgs.shape
        p, r = c.patch_size, c.dec_registers
        nh, nw = H // p, W // p
        mean = torch.tensor(MEAN, device=imgs.device).reshape(1, 1, 3, 1, 1)
        std = torch.tensor(STD, device=imgs.device).reshape(1, 1, 3, 1, 1)
        x = ((imgs.float() - mean) / std).reshape(B * N, 3, H, W)
        hidden = self.encoder(x, resize_pos_embed(self.encoder.pos_embed[:, 1:], nh, nw))
        hidden, pos = self.decode(hidden, B, N, nh, nw)

        def pixels(h, head):     # pixel shuffle of the patch tokens
            y = head.proj(h[:, r:]).reshape(B * N, nh, nw, -1, p, p)
            return y.permute(0, 1, 4, 2, 5, 3).reshape(B, N, H, W, -1)

        ret = pixels(self.point_decoder(hidden, pos), self.point_head)
        z = torch.exp(ret[..., 2:3])
        local_points = torch.cat([ret[..., :2] * z, z], dim=-1)
        conf = pixels(self.conf_decoder(hidden, pos), self.conf_head)
        R, t = self.camera_head(self.camera_decoder(hidden, pos)[:, r:])
        pose = torch.zeros(B * N, 4, 4, device=imgs.device)
        pose[:, :3, :3] = R
        pose[:, :3, 3] = t
        pose[:, 3, 3] = 1.0
        pose = pose.reshape(B, N, 4, 4)
        Rp, tp = pose[:, :, None, None, :3, :3], pose[:, :, None, None, :3, 3]
        points = (Rp * local_points[..., None, :]).sum(dim=-1) + tp
        return dict(points=points, local_points=local_points, conf=conf, camera_poses=pose)


def empty_model(c: Widths, device) -> PlainPi3:
    with torch.device("meta"):
        model = PlainPi3(c)
    return model.to_empty(device=device)


def build(c: Widths, state_dict: dict, device, trunk_quant=None) -> PlainPi3:
    """The model on ``device`` from a released-layout state dict (strict;
    DINOv2's ``encoder.mask_token`` dropped), in float32."""
    model = empty_model(c, device)
    model.load_state_dict({k: v for k, v in state_dict.items() if k != "encoder.mask_token"},
                          strict=True)
    return model.eval().set_trunk_quant(trunk_quant)
