"""XFeat keypoint detector and descriptors in PyTorch.

Port of ``artdeco_tpu/models/xfeat.py``: the public "XFeat: Accelerated
Features for Lightweight Image Matching" (CVPR 2024) architecture and the
fixed-size detect-and-compute pipeline the reference traces.

* backbone: instance-normalised grayscale -> five conv blocks and an
  average-pool skip -> pyramid fusion at 1/8 (sparse, ``block3_stride=2``)
  or 1/4 (the dense variant, ``block3_stride=1``);
* heads: 64-d dense descriptors, 65-channel keypoint logits over 8x8 cells
  (and a dustbin), a one-channel reliability heatmap;
* detection: softmax cell heatmap -> 5x5 max-pool NMS -> the top 1.5 k
  candidates -> reliability re-scoring -> the top k keypoints with
  bilinearly sampled descriptors.

``XFeatModel`` carries the upstream release's module names
(``block1.0.layer.0``, ``skip1.1``, ``keypoint_head.3``, ...), so the
torch-hub checkpoint loads strictly, with or without its ``net.`` prefix
(``load_xfeat_state_dict``; the fine-matcher MLP, which the reference never
calls, is dropped).  BatchNorm is affine-free with running statistics, in
eval mode.

Parity with the JAX package rests on three details: the samplers are the
JAX package's taps (``_grid_coord``, ``_sample_nearest``,
``_sample_bilinear``), not ``F.grid_sample``; both ``top_k``s keep equal
scores in ascending index (on random weights most candidates score 0);
and zero-score keypoints carry zeroed descriptors, the keypoint at (0, 0)
scoring -1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from artdeco_tpu_torch.device import float32_policy, resolve
from artdeco_tpu_torch.models.pi3 import read_state_dict
from artdeco_tpu_torch.poses.feature_detector import top_k_stable


@dataclasses.dataclass(frozen=True)
class XFeatConfig:
    stride: int = 4          # block1's total downsampling (1, 2 or 4)
    block3_stride: int = 2   # 2: the sparse detector (1/8 features), 1: dense
    top_k: int = 4096
    detection_threshold: float = 0.05


def sparse_config(top_k: int = 4096, **kw) -> XFeatConfig:
    """The torch-hub detector (the reference's ``Detector``)."""
    return XFeatConfig(stride=4, block3_stride=2, top_k=top_k, **kw)


def dense_config(**kw) -> XFeatConfig:
    """The dense-descriptor variant (the reference's ``XFeatModel(4)``)."""
    return XFeatConfig(stride=4, block3_stride=1, **kw)


class BasicLayer(nn.Module):
    """Conv -> affine-free BatchNorm (running statistics) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.layer = nn.Sequential(
            nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False),
            nn.BatchNorm2d(cout, affine=False),
            nn.ReLU(inplace=True))

    def forward(self, x):
        return self.layer(x)


def _unfold2d(x, ws: int):
    """(B, C, H, W) -> (B, C * ws * ws, H / ws, W / ws); output channel
    c * ws * ws + wy * ws + wx (the upstream ``_unfold2d``)."""
    b, c, h, w = x.shape
    x = x.unfold(2, ws, ws).unfold(3, ws, ws).reshape(b, c, h // ws, w // ws, ws * ws)
    return x.permute(0, 1, 4, 2, 3).reshape(b, -1, h // ws, w // ws)


class XFeatModel(nn.Module):
    """Backbone and heads over (B, 1, H, W) instance-normalised grayscale;
    returns (feats, keypoint logits, heatmap), NCHW."""

    def __init__(self, cfg: XFeatConfig = XFeatConfig()):
        super().__init__()
        s = cfg.stride
        self.skip1 = nn.Sequential(nn.AvgPool2d(s, stride=s), nn.Conv2d(1, 24, 1))
        b1 = {1: (1, 1, 1, 1), 2: (1, 2, 1, 1), 4: (1, 2, 1, 2)}[s]
        self.block1 = nn.Sequential(
            BasicLayer(1, 4, stride=b1[0]), BasicLayer(4, 8, stride=b1[1]),
            BasicLayer(8, 8, stride=b1[2]), BasicLayer(8, 24, stride=b1[3]))
        self.block2 = nn.Sequential(BasicLayer(24, 24), BasicLayer(24, 24))
        self.block3 = nn.Sequential(
            BasicLayer(24, 64, stride=cfg.block3_stride), BasicLayer(64, 64),
            BasicLayer(64, 64, 1, padding=0))
        self.block4 = nn.Sequential(BasicLayer(64, 64, stride=2), BasicLayer(64, 64),
                                    BasicLayer(64, 64))
        self.block5 = nn.Sequential(
            BasicLayer(64, 128, stride=2), BasicLayer(128, 128), BasicLayer(128, 128),
            BasicLayer(128, 64, 1, padding=0))
        self.block_fusion = nn.Sequential(BasicLayer(64, 64), BasicLayer(64, 64),
                                          nn.Conv2d(64, 64, 1))
        self.heatmap_head = nn.Sequential(
            BasicLayer(64, 64, 1, padding=0), BasicLayer(64, 64, 1, padding=0),
            nn.Conv2d(64, 1, 1), nn.Sigmoid())
        self.keypoint_head = nn.Sequential(
            BasicLayer(64, 64, 1, padding=0), BasicLayer(64, 64, 1, padding=0),
            BasicLayer(64, 64, 1, padding=0), nn.Conv2d(64, 65, 1))

    def forward(self, x):
        x1 = self.block1(x)
        x2 = self.block2(x1 + self.skip1(x))
        x3 = self.block3(x2)
        x4 = self.block4(x3)
        x5 = self.block5(x4)
        size = x3.shape[-2:]
        x4 = F.interpolate(x4, size, mode="bilinear", align_corners=False)
        x5 = F.interpolate(x5, size, mode="bilinear", align_corners=False)
        feats = self.block_fusion(x3 + x4 + x5)
        heatmap = self.heatmap_head(feats)
        keypoints = self.keypoint_head(_unfold2d(x, 8))
        return feats, keypoints, heatmap


def instance_norm_gray(img_bchw):
    """Mean over RGB -> InstanceNorm2d(1, affine=False)."""
    g = img_bchw.mean(dim=1, keepdim=True)
    mu = g.mean(dim=(2, 3), keepdim=True)
    var = g.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (g - mu) * torch.rsqrt(var + 1e-5)


def get_kpts_heatmap(k_logits):
    """(B, 65, h, w) logits -> (B, 8h, 8w): softmax over the 65 cell
    classes, the dustbin dropped, 8x pixel shuffle."""
    scores = torch.softmax(k_logits, dim=1)[:, :64]
    b, _, h, w = scores.shape
    hm = scores.permute(0, 2, 3, 1).reshape(b, h, w, 8, 8)
    return hm.permute(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)


def _grid_coord(pos, norm_size: float, x_size: int):
    """The ``grid_sample(align_corners=False)`` coordinate of ``pos``
    normalised by (norm_size - 1): g = 2 pos / (norm - 1) - 1,
    p = ((g + 1) x_size - 1) / 2.

    Computed as XLA compiles the JAX package's expression: the constants
    folded into one float32 factor c = fl(fl(2 / (norm - 1)) x_size) and
    p = fma(pos, c, -1) / 2 (the fused multiply-add in float64, where the
    product of two float32 values is exact).  Plain float32 arithmetic
    puts the last row at 383.5 instead of 383.49997 at 384 rows, and
    ``round`` then sends it out of the image."""
    c = np.float32(np.float32(2.0 / np.float32(norm_size - 1.0)) * np.float32(x_size))
    return (pos.double() * float(c) - 1.0).float() * 0.5


def _sample_nearest(img_hw, u, v, hn: int, wn: int):
    h, w = img_hw.shape
    pu = torch.round(_grid_coord(u, wn, w)).to(torch.int64)
    pv = torch.round(_grid_coord(v, hn, h)).to(torch.int64)
    inside = (pu >= 0) & (pu < w) & (pv >= 0) & (pv < h)
    val = img_hw[torch.clamp(pv, 0, h - 1), torch.clamp(pu, 0, w - 1)]
    return torch.where(inside, val, 0.0)                   # zeros padding


def _sample_bilinear(img_hwc, u, v, hn: int, wn: int):
    h, w = img_hwc.shape[:2]
    pu = _grid_coord(u, wn, w)
    pv = _grid_coord(v, hn, h)
    u0, v0 = torch.floor(pu), torch.floor(pv)
    du, dv = (pu - u0)[:, None], (pv - v0)[:, None]
    iu, iv = u0.to(torch.int64), v0.to(torch.int64)

    def tap(iv_, iu_):
        inside = (iu_ >= 0) & (iu_ < w) & (iv_ >= 0) & (iv_ < h)
        val = img_hwc[torch.clamp(iv_, 0, h - 1), torch.clamp(iu_, 0, w - 1)]
        return torch.where(inside[:, None], val, 0.0)

    return ((1 - du) * (1 - dv) * tap(iv, iu) + du * (1 - dv) * tap(iv, iu + 1)
            + (1 - du) * dv * tap(iv + 1, iu) + du * dv * tap(iv + 1, iu + 1))


def _l2_normalize(x):
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


@torch.no_grad()
def detect_and_compute(model: XFeatModel, img_bchw, cfg: XFeatConfig):
    """Fixed-size detect-and-compute of a (1, 3, H, W) image in [0, 1].

    Returns (kpts (top_k, 2) at input resolution, feats (top_k, 64),
    scores (top_k,)); zero-score keypoints carry zeroed descriptors."""
    top_k = cfg.top_k
    H, W = img_bchw.shape[-2:]
    H32, W32 = (H // 32) * 32, (W // 32) * 32
    rh, rw = H / H32, W / W32
    x = instance_norm_gray(img_bchw)
    if (H32, W32) != (H, W):      # jax.image.resize "linear": antialiased when shrinking
        x = F.interpolate(x, (H32, W32), mode="bilinear", align_corners=False, antialias=True)
    M1, K1, H1 = model(x)
    M1 = _l2_normalize(M1[0].permute(1, 2, 0))
    K1h = get_kpts_heatmap(K1)[0]                 # (H32, W32)
    H1 = H1[0].permute(1, 2, 0)                   # (H32 / 8, W32 / 8, 1)

    # NMS: 5x5 max-pool peaks above the threshold, the top 1.5 k candidates
    nvalid = int(1.5 * top_k)
    pooled = F.max_pool2d(K1h[None, None], 5, stride=1, padding=2)[0, 0]
    xTot = K1h * (K1h == pooled) * (K1h > cfg.detection_threshold)
    xOut, pos1d = top_k_stable(xTot.reshape(-1), nvalid)
    mk_u = (pos1d % W32).to(torch.float32)
    mk_v = (pos1d // W32).to(torch.float32)

    # reliability: nearest(K1h) * bilinear(H1); the keypoint at (0, 0) scores -1
    sc = (_sample_nearest(K1h, mk_u, mk_v, H32, W32)
          * _sample_bilinear(H1, mk_u, mk_v, H32, W32)[:, 0])
    sc = torch.where((mk_u == 0) & (mk_v == 0), -1.0, sc)
    sc_top, idxs = top_k_stable(sc, top_k)
    u, v = mk_u[idxs], mk_v[idxs]
    scores = sc_top * (xOut[idxs] > 0)

    feats = _l2_normalize(_sample_bilinear(M1, u, v, H32, W32))
    feats = feats * (scores[:, None] > 0)
    return torch.stack([u * rw, v * rh], dim=-1), feats, scores


def _resize_ac_axis(a, dim: int, out_n: int):
    """Linear resampling with align_corners=True along ``dim`` (the JAX
    package's gather form)."""
    n = a.shape[dim]
    pos = torch.linspace(0.0, n - 1.0, out_n, device=a.device)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    t = pos - i0
    shape = [1] * a.ndim
    shape[dim] = out_n
    t = t.reshape(shape)
    return a.index_select(dim, i0) * (1 - t) + a.index_select(dim, i0 + 1) * t


@torch.no_grad()
def dense_features(model: XFeatModel, img_bchw):
    """The L2-normalised fused feature map of (B, 3, H, W) images in [0, 1],
    NHWC at 1/stride; a size off the multiple of 32 is resized with
    align_corners=True first (the reference's dense preprocess)."""
    H, W = img_bchw.shape[-2:]
    H32, W32 = (H // 32) * 32, (W // 32) * 32
    x = instance_norm_gray(img_bchw)
    if (H32, W32) != (H, W):
        x = _resize_ac_axis(_resize_ac_axis(x, 2, H32), 3, W32)
    feats, _, _ = model(x)
    return _l2_normalize(feats.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def load_xfeat_state_dict(model: XFeatModel, sd: dict) -> XFeatModel:
    """Load the torch-hub state dict (keys ``net.block1...`` or bare)
    strictly; the unused fine-matcher MLP is dropped."""
    if any(k.startswith("net.") for k in sd):
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    sd = {k: torch.tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
          for k, v in sd.items() if not k.startswith("fine_matcher.")}
    model.load_state_dict(sd, strict=True)
    return model


def random_xfeat(cfg: XFeatConfig, generator: torch.Generator, device) -> XFeatModel:
    """A model on ``device`` with seeded random weights drawn there: conv
    kernels normal(0, 2 / fan_in) (He's scale, which keeps the activations'
    size through the ReLUs, so the keypoint logits are not flat and some
    cells pass the detection threshold), biases 0, running mean 0 and
    variance 1."""
    model = XFeatModel(cfg).to(device)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(".weight"):
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=generator, device=device)
                        * np.sqrt(2.0 / fan_in))
            elif name.endswith((".bias", "running_mean")):
                t.zero_()
            elif name.endswith("running_var"):
                t.fill_(1.0)
    return model


def state_dict_from_flax(params: dict) -> dict:
    """A JAX package params tree -> the release-layout state dict (numpy):
    the inverse of ``convert_xfeat_state_dict``."""
    p = params.get("params", params)
    a = np.asarray
    sd = {}

    def conv(name, t):
        sd[f"{name}.weight"] = np.ascontiguousarray(a(t["kernel"], np.float32)
                                                    .transpose(3, 2, 0, 1))
        if "bias" in t:
            sd[f"{name}.bias"] = a(t["bias"], np.float32).copy()

    def basic(name, t):
        conv(f"{name}.layer.0", t["conv"])
        sd[f"{name}.layer.1.running_mean"] = a(t["bn_mean"], np.float32).copy()
        sd[f"{name}.layer.1.running_var"] = a(t["bn_var"], np.float32).copy()
        sd[f"{name}.layer.1.num_batches_tracked"] = np.zeros((), np.int64)

    conv("skip1.1", p["skip1_conv"])
    for i in range(4):
        basic(f"block1.{i}", p[f"block1_{i}"])
        basic(f"block5.{i}", p[f"block5_{i}"])
    for i in range(2):
        basic(f"block2.{i}", p[f"block2_{i}"])
    for i in range(3):
        basic(f"block3.{i}", p[f"block3_{i}"])
        basic(f"block4.{i}", p[f"block4_{i}"])
        basic(f"keypoint_head.{i}", p[f"kpt_{i}"])
    basic("block_fusion.0", p["fusion_0"])
    basic("block_fusion.1", p["fusion_1"])
    conv("block_fusion.2", p["fusion_conv"])
    basic("heatmap_head.0", p["heat_0"])
    basic("heatmap_head.1", p["heat_1"])
    conv("heatmap_head.2", p["heat_conv"])
    conv("keypoint_head.3", p["kpt_conv"])
    return sd


def load_xfeat(cfg: XFeatConfig, checkpoint_path: str = "", *, device=None,
               seed: int = 0) -> XFeatModel:
    """An ``XFeatModel`` in eval mode on ``device`` (None: the CUDA device):
    weights from a ``.pth`` / ``.safetensors`` checkpoint, else random,
    drawn on ``device`` from a generator seeded by ``seed``."""
    device = resolve(device)
    if device.type == "cuda":
        float32_policy()
    if checkpoint_path:
        model = load_xfeat_state_dict(XFeatModel(cfg), read_state_dict(checkpoint_path))
    else:
        model = random_xfeat(cfg, torch.Generator(device=device).manual_seed(seed), device)
    return model.to(device).eval()


def make_detector(checkpoint_path: str = "", top_k: int = 1024, *, device=None,
                  seed: int = 0):
    """The sparse detector: ``fn(img_chw) -> (kpts, feats, scores)`` on
    ``device``.  Without a checkpoint the net has random weights: the
    pipeline runs, the keypoints mean nothing."""
    cfg = sparse_config(top_k=top_k)
    model = load_xfeat(cfg, checkpoint_path, device=device, seed=seed)
    dev = next(model.parameters()).device

    def fn(img_chw):
        img = torch.as_tensor(img_chw, dtype=torch.float32, device=dev)[None]
        if float(img.min()) < -0.01:     # [-1, 1] -> [0, 1]
            img = (img + 1.0) / 2.0
        return detect_and_compute(model, img, cfg)

    fn.model = model
    return fn


def make_dense_fn(checkpoint_path: str = "", *, device=None, seed: int = 0):
    """The dense variant for ``mapper.mono_depth.DenseExtractor``:
    ``fn(img_chw) -> (H / 4, W / 4, 64)`` descriptors as a numpy array."""
    model = load_xfeat(dense_config(), checkpoint_path, device=device, seed=seed)
    dev = next(model.parameters()).device

    def fn(img_chw):
        img = torch.as_tensor(img_chw, dtype=torch.float32, device=dev)[None]
        return dense_features(model, img)[0].cpu().numpy()

    fn.model = model
    return fn
