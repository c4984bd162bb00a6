"""Mutual nearest-neighbour descriptor matching.

Port of ``artdeco_tpu/poses/matcher.py``: cosine similarity (the
descriptors are unit vectors) by one matrix product, mutual nearest
neighbours above a minimum similarity.  ``argmax`` keeps the first of
equal maxima, as JAX's does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Matches:
    idx: torch.Tensor         # (M,) indices into the first frame's keypoints
    kpts_other: torch.Tensor  # (M, 2) matched pixels in the other frame
    sim: torch.Tensor         # (M,) cosine similarities
    idx_other: torch.Tensor   # (M,) indices into the other frame's keypoints


def mutual_nn(desc1: torch.Tensor, desc2: torch.Tensor, min_sim: float = 0.8):
    """Returns (idx2_of_1 (N1,), mutual (N1,) bool, sim (N1,))."""
    sim = desc1 @ desc2.T
    nn12 = torch.argmax(sim, dim=1)
    nn21 = torch.argmax(sim, dim=0)
    best = torch.take_along_dim(sim, nn12[:, None], dim=1)[:, 0]
    mutual = (nn21[nn12] == torch.arange(desc1.shape[0], device=desc1.device)) & (best > min_sim)
    return nn12, mutual, best


def match_described(d1, d2, min_sim: float = 0.8) -> Matches:
    """Two ``DescribedKeypoints`` -> their mutual matches."""
    nn12, mutual, sim = mutual_nn(d1.desc, d2.desc, min_sim)
    sel = torch.nonzero(mutual).flatten()
    other = nn12[sel]
    return Matches(idx=sel, kpts_other=d2.kpts[other], sim=sim[sel], idx_other=other)
