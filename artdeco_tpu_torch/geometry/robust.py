"""Robust weights and convergence tests.

Port of ``artdeco_tpu/geometry/robust.py``.
"""

from __future__ import annotations

import torch


def huber(r, k: float = 1.345):
    """Huber IRLS weight: 1 inside |r| < k, k/|r| outside."""
    r_abs = torch.abs(r)
    return torch.where(r_abs < k, torch.ones_like(r), k / torch.clamp_min(r_abs, 1e-12))


def tukey(r, t: float = 4.6851):
    r_abs = torch.abs(r)
    tmp = 1.0 - torch.square(r_abs / t)
    return torch.where(r_abs < t, tmp * tmp, torch.zeros_like(r))


def check_convergence(rel_error_threshold: float, delta_norm_threshold: float,
                      old_cost, new_cost, delta):
    """Convergence predicate as a device bool: relative cost decrease or
    step norm below its threshold."""
    rel_dec = torch.abs((old_cost - new_cost) / torch.clamp_min(old_cost, 1e-30))
    delta_norm = torch.linalg.vector_norm(delta)
    return (rel_dec < rel_error_threshold) | (delta_norm < delta_norm_threshold)
