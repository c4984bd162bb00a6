"""``iter_proj``: K4 (``csrc/iter_proj.cu``) against ``iter_proj_plain``,
and the wrapper around both.  This file imports no JAX, so its ``cuda``
tests run where the JAX package is not installed:

    python -m pytest tests/test_torch_iter_proj.py -q -m cuda

On the CPU: the tail rule both paths share (``tail_runs``) at its threshold
against the plain path's former ``1 - mean(conv)``; the plain path's rule
per row, on rows just under and just over it; the wrapper's checks raising
before any dispatch; CPU tensors taking the plain path.

On the card (``cuda`` marker): K4 bitwise ``iter_proj_plain`` in positions
and flags, at b = 1, 2, 8, on the oracle pair at 512x288, on random
MASt3R-shaped pointmaps at 512x384 with warm starts, and on the same with
NaN and inf points planted; rows just under and just over the tail rule in
one batch; ``max_iter`` = ``HEAD_ITERS`` (one launch); the whole cascade
through K4 and through the plain path; no host read inside a K4 call.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from artdeco_tpu_torch import kernels, trace
from artdeco_tpu_torch.ops import matching as M
from matching_cases import MATCH_CFG, oracle_pair

LM = dict(max_iter=10, lambda_init=1e-8, cost_thresh=1e-6)


def oracle_inputs(b, h, w, device="cpu"):
    """prep_for_iter_proj of b oracle pairs, the row e ``e + 1`` frames
    apart, from the identity start."""
    pairs = [oracle_pair(h, w, shift=e + 1) for e in range(b)]
    X11 = torch.tensor(np.concatenate([p[0] for p in pairs])).to(device)
    X21 = torch.tensor(np.concatenate([p[1] for p in pairs])).to(device)
    return M.prep_for_iter_proj(X11, X21, None)


def mast3r_inputs(b, h=384, w=512, nonfinite=False, device="cpu"):
    """prep_for_iter_proj of b random pointmap pairs shaped like MASt3R's:
    rays through a focal of 0.8 w times a smooth depth in [1, 4] m, frame 2
    the same surface 2-3 pixels away with 1 cm of noise, warm-started at
    the identity moved by up to 3 pixels.  ``nonfinite`` plants NaN and inf
    points in both frames."""
    g = torch.Generator().manual_seed(7 + b)
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                          torch.arange(w, dtype=torch.float32), indexing="ij")
    f = 0.8 * w
    ray = torch.stack([(u - (w - 1) / 2) / f, (v - (h - 1) / 2) / f, torch.ones(h, w)], -1)
    coarse = torch.rand(b, 1, h // 32, w // 32, generator=g)
    depth = 1.0 + 3.0 * F.interpolate(coarse, size=(h, w), mode="bilinear",
                                      align_corners=False)[:, 0]
    X11 = ray * depth[..., None]
    X21 = torch.roll(X11, shifts=(2, 3), dims=(1, 2)) \
        + 0.01 * torch.randn(X11.shape, generator=g)
    if nonfinite:
        for X in (X11, X21):
            flat = X.view(b, h * w, 3)
            idx = torch.randint(0, h * w, (b, 64), generator=g)
            for e in range(b):
                flat[e, idx[e, :32], e % 3] = float("nan")
                flat[e, idx[e, 32:48]] = float("inf")
                flat[e, idx[e, 48:], 2] = float("-inf")
    du = torch.randint(-3, 4, (b, h * w), generator=g)
    dv = torch.randint(-3, 4, (b, h * w), generator=g)
    lin = torch.arange(h * w).expand(b, h * w)
    init = ((lin // w + dv).clamp(0, h - 1) * w + (lin % w + du).clamp(0, w - 1))
    return M.prep_for_iter_proj(X11.to(device), X21.to(device), init.to(device))


def straddle_rows(rays, pts, p_init, lm):
    """Two rows built from row 0: after the head, row 0 has one unconverged
    pixel fewer than the tail rule needs and row 1 exactly as many.  The
    unconverged pixels kept are the head's own (their points unchanged);
    every other pixel gets the unit ray at its (clamped) start as its
    point, so it converges at once.  Returns (rays, pts, p_init) of the two
    rows."""
    _, h, w, _ = rays.shape
    n = pts.shape[1]
    need = next(k for k in range(n + 1) if M.tail_runs(n - k, n))
    _, conv = M.iter_proj_plain(rays[:1], pts[:1], p_init[:1],
                                **{**lm, "max_iter": M.HEAD_ITERS})
    unconv = torch.nonzero(~conv[0]).flatten()
    assert unconv.numel() >= need, (unconv.numel(), need)
    u = p_init[0, :, 0].clamp(1, w - 2).long()
    v = p_init[0, :, 1].clamp(1, h - 2).long()
    own = rays[0, v, u, :3]
    rows = []
    for k in (need - 1, need):
        keep = torch.zeros(n, dtype=torch.bool, device=pts.device)
        keep[unconv[:k]] = True
        rows.append(torch.where(keep[:, None], pts[0], own))
    out = (rays[:1].expand(2, -1, -1, -1), torch.stack(rows), p_init[:1].expand(2, -1, -1))
    _, conv = M.iter_proj_plain(*out, **{**lm, "max_iter": M.HEAD_ITERS})
    assert (~conv).sum(-1).tolist() == [need - 1, need]
    return out


def assert_bitwise(a, b):
    """Positions (float) by their bits, flags exactly."""
    pa, ca = (x.cpu() for x in a)
    pb, cb = (x.cpu() for x in b)
    assert pa.shape == pb.shape and ca.shape == cb.shape
    np.testing.assert_array_equal(pa.numpy().view(np.uint32), pb.numpy().view(np.uint32))
    np.testing.assert_array_equal(ca.numpy(), cb.numpy())


# -- on the CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [147456, 196608, 12288, 3072, 1000])
def test_tail_rule_at_its_threshold(n):
    """``tail_runs`` flips where n - n_conv first exceeds n / 500, and
    agrees at the threshold and one converged pixel either side with the
    rule as the plain path computed it before, ``1 - conv.float().mean()
    > EARLY_EXIT_FRAC`` (the JAX package's ``1 - mean(conv)``)."""
    first_skip = n - n // 500           # the fewest converged pixels that skip the tail
    for c in (first_skip - 1, first_skip, first_skip + 1):
        conv = torch.arange(n) < c
        mean_rule = bool(1.0 - conv.float().mean() > M.EARLY_EXIT_FRAC)
        assert M.tail_runs(c, n) == mean_rule == (c < first_skip), c


def test_plain_path_takes_the_tail_per_row():
    """Rows just under and just over the tail rule in one batch: the first
    ends after the head, the second runs its tail (its unconverged pixels
    move on), each as it would alone."""
    rays, pts, p_init = straddle_rows(*oracle_inputs(1, 48, 64), LM)
    p, conv = M.iter_proj_plain(rays, pts, p_init, **LM)
    p_head, conv_head = M.iter_proj_plain(rays, pts, p_init,
                                          **{**LM, "max_iter": M.HEAD_ITERS})
    assert torch.equal(p[0], p_head[0]) and torch.equal(conv[0], conv_head[0])
    assert not torch.equal(p[1], p_head[1])
    for e in range(2):
        assert_bitwise((p[e:e + 1], conv[e:e + 1]),
                       M.iter_proj_plain(rays[e:e + 1], pts[e:e + 1], p_init[e:e + 1], **LM))


def _no_kernel():
    raise AssertionError("the kernel library was loaded")


BAD = {
    "rays_channels": lambda r, p, q: (r[..., :8], p, q),
    "pts_shape": lambda r, p, q: (r, p[:, :-1], q),
    "p_init_shape": lambda r, p, q: (r, p, q[..., :1]),
    "rows": lambda r, p, q: (r[:1], p, q),
    "float64": lambda r, p, q: (r, p.double(), q),
    "int_start": lambda r, p, q: (r, p, q.int()),
    "device": lambda r, p, q: (r, p.to("meta"), q),
    "unsupported": lambda r, p, q: (r.to("meta"), p.to("meta"), q.to("meta")),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_iter_proj_checks_raise_before_dispatch(bad, monkeypatch):
    """Wrong shapes, dtypes or devices raise ValueError before the plain
    path runs or the kernel library loads."""
    monkeypatch.setattr(kernels, "load", _no_kernel)
    monkeypatch.setattr(M, "iter_proj_plain", lambda *a, **k: _no_kernel())
    args = BAD[bad](*oracle_inputs(2, 12, 16))
    before = M.iter_proj.launches
    with pytest.raises(ValueError, match="iter_proj"):
        M.iter_proj(*args, **LM)
    assert M.iter_proj.launches == before


def test_iter_proj_on_cpu_takes_the_plain_path(monkeypatch):
    """CPU tensors run ``iter_proj_plain``: no library, no launch, no
    rows counted, the plain path's bits."""
    monkeypatch.setattr(kernels, "load", _no_kernel)
    inputs = oracle_inputs(2, 48, 64)
    before, rows = M.iter_proj.launches, trace.counters().get("iter_proj.rows", 0)
    out = M.iter_proj(*inputs, **LM)
    assert M.iter_proj.launches == before
    assert trace.counters().get("iter_proj.rows", 0) == rows
    assert_bitwise(out, M.iter_proj_plain(*inputs, **LM))


# -- on the card -----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 runs only on the card")
    return torch.device("cuda")


CARD_CASES = {
    "oracle-512x288": lambda b, dev: oracle_inputs(b, 288, 512, device=dev),
    "mast3r-512x384": lambda b, dev: mast3r_inputs(b, device=dev),
    "nonfinite-512x384": lambda b, dev: mast3r_inputs(b, nonfinite=True, device=dev),
}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_k4_matches_plain_version_on_card(cuda_device, case, b):
    """K4 bitwise ``iter_proj_plain`` on the card, in two launches, its
    rows counted."""
    inputs = CARD_CASES[case](b, cuda_device)
    before, rows = M.iter_proj.launches, trace.counters().get("iter_proj.rows", 0)
    out = M.iter_proj(*inputs, **LM)
    plain = M.iter_proj_plain(*inputs, **LM)
    torch.cuda.synchronize()
    assert M.iter_proj.launches == before + 2
    assert trace.counters()["iter_proj.rows"] == rows + b
    assert_bitwise(out, plain)


@pytest.mark.cuda
def test_k4_takes_the_tail_per_row_on_card(cuda_device):
    """Rows just under and just over the tail rule at 512x288 in one batch:
    K4 ends the first after the head and runs the second's tail, bitwise
    the plain path."""
    rays, pts, p_init = straddle_rows(*oracle_inputs(1, 288, 512, device=cuda_device), LM)
    out = M.iter_proj(rays, pts, p_init, **LM)
    head = M.iter_proj_plain(rays, pts, p_init, **{**LM, "max_iter": M.HEAD_ITERS})
    assert_bitwise(out, M.iter_proj_plain(rays, pts, p_init, **LM))
    assert torch.equal(out[0][0], head[0][0]) and not torch.equal(out[0][1], head[0][1])


@pytest.mark.cuda
def test_k4_head_only_on_card(cuda_device, monkeypatch):
    """``max_iter`` = ``HEAD_ITERS`` set by a wrapper under the module's
    name, as the benchmark's ``iter_proj_cut`` fault plants it: the cascade
    calls the wrapper, K4 launches once and counts it on itself, bitwise
    the plain path."""
    pairs = [oracle_pair(288, 512, shift=s) for s in (1, 3)]
    X11, X21 = (torch.tensor(np.concatenate([p[k] for p in pairs])).to(cuda_device)
                for k in range(2))
    k4, calls = M.iter_proj, []

    def cut(*a, **k):
        calls.append(k["max_iter"])
        k["max_iter"] = M.HEAD_ITERS
        return k4(*a, **k)

    monkeypatch.setattr(M, "iter_proj", cut)
    before = k4.launches
    p1, _ = M.project_matches(X11, X21, None, max_iter=10, lambda_init=1e-8,
                              cost_thresh=1e-6, dist_thresh=0.1)
    assert calls == [10] and k4.launches == before + 1
    inputs = M.prep_for_iter_proj(X11, X21, None)
    lm = {**LM, "max_iter": M.HEAD_ITERS}
    out = k4(*inputs, **lm)
    plain = M.iter_proj_plain(*inputs, **lm)
    assert_bitwise(out, plain)
    assert torch.equal(p1, plain[0].to(torch.int32))


@pytest.mark.cuda
def test_cascade_through_k4_equals_plain_on_card(cuda_device, monkeypatch):
    """``match`` on two oracle pairs at 512x288 gives the same indices and
    validity through K4 as through the plain path."""
    pairs = [oracle_pair(288, 512, shift=s) for s in (1, 3)]
    args = [torch.tensor(np.concatenate([p[k] for p in pairs])).to(cuda_device)
            for k in range(4)]
    before = M.iter_proj.launches
    idx, valid = M.match(MATCH_CFG, *args)
    assert M.iter_proj.launches == before + 2
    monkeypatch.setattr(M, "iter_proj", M.iter_proj_plain)
    idx_p, valid_p = M.match(MATCH_CFG, *args)
    assert torch.equal(idx, idx_p) and torch.equal(valid, valid_p)
    assert valid.float().mean() > 0.5


@pytest.mark.cuda
def test_k4_makes_no_host_read_on_card(cuda_device):
    """A K4 call reads nothing back from the device; the plain path's read
    of each row's converged count is what the sync check catches."""
    inputs = oracle_inputs(2, 288, 512, device=cuda_device)
    M.iter_proj(*inputs, **LM)           # the library is built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        M.iter_proj(*inputs, **LM)
        with pytest.raises(RuntimeError):
            M.iter_proj_plain(*inputs, **LM)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
