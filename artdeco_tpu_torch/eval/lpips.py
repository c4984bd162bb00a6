"""LPIPS perceptual metric (AlexNet-feature variant) in PyTorch.

Port of ``artdeco_tpu/eval/lpips.py``: AlexNet conv features at five
depths -> per-channel unit normalisation -> squared difference -> the
non-negative 1x1 "lin" head of each layer -> spatial mean -> sum over
layers.  Inputs are (3, H, W) images in [0, 1], mapped to [-1, 1] and
shifted and scaled by LPIPS's fixed per-channel constants.

Weights come from ``convert_lpips_torch(state_dict)`` (torchvision AlexNet
``features.{0,3,6,8,10}`` plus LPIPS's ``lin{0..4}.model.1.weight``) or
from ``random_lpips_params(seed)``, the seeded random AlexNet that the JAX
package falls back to: the same ``np.random.RandomState`` draws, so both
packages score with the same weights.  Scores from the fallback are
comparable across runs of this code base, not to the official LPIPS.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet features: (out_ch, kernel, stride, pad)
_ALEX_CFG = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)     # maxpool(3, stride 2) after relu1 and relu2
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LpipsParams(NamedTuple):
    conv_w: tuple   # per layer (out, in, kh, kw), numpy float32
    conv_b: tuple   # per layer (out,)
    lin_w: tuple    # per layer (out_ch,), non-negative


def random_lpips_params(seed: int = 0) -> LpipsParams:
    """The seeded random-init AlexNet-LPIPS (the JAX package's fallback)."""
    rng = np.random.RandomState(seed)
    conv_w, conv_b, lin_w = [], [], []
    in_ch = 3
    for out_ch, k, _, _ in _ALEX_CFG:
        std = (2.0 / (in_ch * k * k)) ** 0.5
        conv_w.append(rng.randn(out_ch, in_ch, k, k).astype(np.float32) * std)
        conv_b.append(np.zeros((out_ch,), np.float32))
        lin_w.append(np.full((out_ch,), 1.0 / out_ch, np.float32))
        in_ch = out_ch
    return LpipsParams(tuple(conv_w), tuple(conv_b), tuple(lin_w))


def convert_lpips_torch(state_dict) -> LpipsParams:
    """Params from a state dict of torchvision AlexNet features and LPIPS
    linear heads (tensors or numpy arrays)."""

    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    feat_ids = (0, 3, 6, 8, 10)
    conv_w = tuple(arr(state_dict[f"features.{i}.weight"]) for i in feat_ids)
    conv_b = tuple(arr(state_dict[f"features.{i}.bias"]) for i in feat_ids)
    lin_w = tuple(np.maximum(arr(state_dict[f"lin{k}.model.1.weight"]).reshape(-1), 0.0)
                  for k in range(5))
    return LpipsParams(conv_w, conv_b, lin_w)


class Lpips:
    """``Lpips()(img0, img1)`` with (3, H, W) tensors in [0, 1]: a 0-d
    float32 tensor on the images' device.  The weights go to a device once,
    at its first call there."""

    def __init__(self, params: LpipsParams | None = None):
        self.params = params if params is not None else random_lpips_params()
        self.is_fallback = params is None
        self._on: dict = {}

    def _weights(self, device: torch.device):
        hit = self._on.get(device)
        if hit is None:
            def dev(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            hit = ([dev(w) for w in self.params.conv_w], [dev(b) for b in self.params.conv_b],
                   [dev(w) for w in self.params.lin_w], dev(_SHIFT)[:, None, None],
                   dev(_SCALE)[:, None, None])
            self._on[device] = hit
        return hit

    @torch.no_grad()
    def __call__(self, img0, img1):
        img0 = torch.as_tensor(img0, dtype=torch.float32)
        img1 = torch.as_tensor(img1, dtype=torch.float32, device=img0.device)
        conv_w, conv_b, lin_w, shift, scale = self._weights(img0.device)
        # both images through the net as one batch of two
        x = (torch.stack([img0, img1]) * 2.0 - 1.0 - shift) / scale
        total = torch.zeros((), dtype=torch.float32, device=img0.device)
        for i, (w, b, lw) in enumerate(zip(conv_w, conv_b, lin_w)):
            _, _, s, p = _ALEX_CFG[i]
            x = F.relu(F.conv2d(x, w, b, stride=s, padding=p))
            f = x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-10)
            d = (f[0] - f[1]) ** 2
            total = total + torch.mean(torch.sum(d * lw[:, None, None], dim=0))
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return total


_default: Lpips | None = None


def get_default_lpips() -> Lpips:
    """The process-wide LPIPS: a converted checkpoint from
    ``$ARTDECO_LPIPS_NPZ`` (an .npz of the torch tensors, see
    ``convert_lpips_torch``) when the file exists, else the seeded fallback."""
    global _default
    if _default is None:
        path = os.environ.get("ARTDECO_LPIPS_NPZ", "")
        if path and os.path.exists(path):
            with np.load(path) as data:
                _default = Lpips(convert_lpips_torch(dict(data)))
        else:
            _default = Lpips()
    return _default
