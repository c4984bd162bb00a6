"""The full-width models on the card (``cuda`` marker; skipped without a
CUDA device).  This file imports no JAX model code, so it also runs where
flax is not installed:

    python -m pytest tests/test_torch_model_card.py -q -m cuda

One full-width (ViT-L, bf16 trunk) MASt3R pair at 512x384 on seeded random
weights drawn on the card: finite points, confidences and descriptor
confidences, unit descriptors (within 1e-3), and a tracking match through
K3 (one launch).
"""

import pytest
import torch

from artdeco_tpu_torch.models import mast3r as TM
from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner


@pytest.mark.cuda
def test_full_width_pair_on_the_card():
    """One full-width (ViT-L, bf16) 512x384 pair on the card: finite
    points, confidences and unit descriptors, and a match through K3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from artdeco_tpu_torch.device import float32_policy
    from artdeco_tpu_torch.ops import refine_dense as RD

    float32_policy()
    dev = torch.device("cuda")
    runner = Mast3rRunner.create(TM.MASt3RConfig(), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    img_i, img_j = (torch.rand(3, 384, 512, generator=g, device=dev) * 2 - 1 for _ in range(2))
    RD.window_argmax.launches = 0
    out = runner.match_asymmetric(img_i, img_j)
    assert RD.window_argmax.launches == 1
    idx, valid, Xii, Cii, Qii, Xji = out[:6]
    assert idx.shape == (1, 384 * 512) and Xii.shape == (384 * 512, 3)
    for x in (Xii, Cii, Qii, Xji):
        assert torch.isfinite(x).all()
    r1, _ = runner.decode(*runner.encode_image(img_i[None]), *runner.encode_image(img_j[None]),
                          (384, 512))
    norms = torch.linalg.vector_norm(r1["desc"], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-3)
