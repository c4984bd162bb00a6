"""Device selection for the port's main path.

The entry points run on a CUDA device unless the caller passes another.
There is no silent CPU fallback: code that wants the CPU (the parity
tests) passes ``torch.device("cpu")`` explicitly.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "artdeco_tpu_torch: no CUDA device is available "
            "(pass torch.device('cpu') explicitly to run on the CPU)"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA device
    (``require_cuda``, which raises when there is none)."""
    return require_cuda() if device is None else torch.device(device)
