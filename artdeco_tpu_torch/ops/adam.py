"""Visibility-masked Adam without bias correction (3DGS style), plain
PyTorch.

Port of ``artdeco_tpu/ops/adam.py``.  Functional: each update returns the
new parameter and moments and leaves its inputs untouched.  These are
memory-bound elementwise passes; PyTorch runs each as a few fused
elementwise kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor


def init_state(param: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros_like(param), torch.zeros_like(param))


def adam_update_basic(param, grad, state: AdamState, lr, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-15):
    """Dense Adam without bias correction (adamUpdateBasic)."""
    m = b1 * state.exp_avg + (1.0 - b1) * grad
    v = b2 * state.exp_avg_sq + (1.0 - b2) * grad * grad
    new_param = param - lr * m / (torch.sqrt(v) + eps)
    return new_param, AdamState(m, v)


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def adam_update_masked(param, grad, state: AdamState, lr,
                       visibility: torch.Tensor, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-15):
    """Visibility-masked Adam (adamUpdate): rows where ``visibility`` is
    False keep param and moments untouched.  ``lr`` is a scalar or an (N,)
    per-row tensor."""
    vis = _rows(visibility, param)
    m = torch.where(vis, b1 * state.exp_avg + (1.0 - b1) * grad, state.exp_avg)
    v = torch.where(vis, b2 * state.exp_avg_sq + (1.0 - b2) * grad * grad,
                    state.exp_avg_sq)
    if isinstance(lr, torch.Tensor) and lr.dim() >= 1:
        lr = _rows(lr, param)
    new_param = torch.where(vis, param - lr * m / (torch.sqrt(v) + eps), param)
    return new_param, AdamState(m, v)


def decay_lr_masked(lr: torch.Tensor, visibility: torch.Tensor, decay: float,
                    lr_min: float) -> torch.Tensor:
    """Per-row lr decay for visible rows, clamped from below."""
    return torch.clamp_min(torch.where(visibility, lr * decay, lr), lr_min)
