"""Micro-profile of the refine search (K3) and of ``iter_proj`` at the
matcher's production shape.

Port of ``scripts/profile_refine.py`` on the card (``device`` "cpu" runs it
on the CPU): the whole refine (``refine_matches_dense_single``, dilations
5..1, radius 4) at 288x512 with 24 channels and the JAX script's jittered
queries, K3 (``window_argmax``) alone on one dilation (d = 5, d = 1), and
``iter_proj`` at b = 1 from a random and from the identity start.

The JAX script's "claim+scatter glue" and "sparse loser pass" rows time
its XLA route's internals: the claim pass that makes the search dense in
image-1 space and the drain of collision losers.  K3 walks each query's own
window on every level in one launch, so the port has neither; in their
place this times the port's own glue around K3: the bf16 casts and the
re-layout of the image descriptors into three 8-channel planes (what
``window_argmax`` does before its launch), and the per-level gathers of
the plain version (``window_argmax_plain`` on one level: each query's
window gathered channel by channel), which K3 replaces.  Rows are timed by
CUDA events over back-to-back calls (``bench.time_ms``) and name the card
and its power limit.

Usage:
  python -m artdeco_tpu_torch.scripts.profile_refine
"""

import argparse

import numpy as np
import torch

from artdeco_tpu_torch.bench import card_label, log, time_ms
from artdeco_tpu_torch.device import float32_policy, resolve


def main(device=None, h: int = 288, w: int = 512, f: int = 24, repeats: int = 4) -> dict:
    """Profile on ``device`` (default: the card); returns {row: ms}."""
    from artdeco_tpu_torch.ops import matching as M
    from artdeco_tpu_torch.ops import refine_dense as RD

    dev = resolve(device)
    float32_policy()
    n = h * w
    radius, dilation_max = 4, 5
    rng = np.random.RandomState(0)
    D11 = torch.as_tensor(rng.rand(h, w, f).astype(np.float32), device=dev)
    D21 = torch.as_tensor(rng.rand(n, f).astype(np.float32), device=dev)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    jitter = rng.randint(-6, 7, size=(2, n))
    p1 = torch.as_tensor(np.stack([np.clip(uu.reshape(-1) + jitter[0], 1, w - 2),
                                   np.clip(vv.reshape(-1) + jitter[1], 1, h - 2)], -1)
                         .astype(np.int32), device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    D11b, D21b = D11.to(torch.bfloat16), D21.to(torch.bfloat16)
    rows = {}
    log(f"refine at {h}x{w}x{f}, r{radius} [{card_label(str(dev))}]")

    def row(name, fn, reps=repeats):
        rows[name] = time_ms(fn, reps, dev)
        log(f"  {name}: {rows[name]:.3f} ms")

    row("refine_dense full (5 levels)",
        lambda: RD.refine_matches_dense_single(D11, D21, p1, radius=radius,
                                               dilation_max=dilation_max))
    for d in (5, 1):
        row(f"K3 window_argmax d={d} (81 offsets)",
            lambda d=d: RD.window_argmax(D11b, D21b, p1, valid, radius, d, d))
    nplanes = 3
    row("glue: bf16 casts + 3 x 8-channel planes",
        lambda: (D11.to(torch.bfloat16).reshape(h, w, nplanes, f // nplanes)
                 .permute(2, 0, 1, 3).contiguous(), D21.to(torch.bfloat16)), reps=8)
    row("per-level gathers (plain version, d=5)",
        lambda: RD.window_argmax_plain(D11b, D21b, p1, valid, radius, 5, 5, RD.FLT_MIN),
        reps=1)

    X11 = torch.as_tensor(rng.rand(1, h, w, 3).astype(np.float32) + 0.5, device=dev)
    X21 = torch.as_tensor(rng.rand(1, h, w, 3).astype(np.float32) + 0.5, device=dev)
    rwg, ptn, _ = M.prep_for_iter_proj(X11, X21, None)
    p_rand = torch.as_tensor(np.stack([rng.uniform(1, w - 2, n), rng.uniform(1, h - 2, n)],
                                      -1)[None].astype(np.float32), device=dev)
    row("iter_proj b=1 (10 it, random init)",
        lambda: M.iter_proj(rwg, ptn, p_rand, max_iter=10))
    init = torch.arange(n, device=dev)[None]
    row("iter_proj b=1 (identity init)",
        lambda: M.iter_proj(rwg, ptn, M.prep_for_iter_proj(X11, X21, init)[2], max_iter=10))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
