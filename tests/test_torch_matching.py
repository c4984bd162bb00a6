"""The port's matching cascade and K3 against the JAX package, on the CPU.

* ``img_gradient`` and the prep: elementwise f32 in both, 1e-6.
* ``iter_proj``: XLA on the CPU contracts ``a * b + c`` into one FMA,
  eager PyTorch rounds the product first, so positions differ by f32
  ulps after the first step (<= 2.7e-5 px measured), and ten LM steps at
  lambda ~ 1e-8 move them apart by up to 7.4e-3 px (measured; the
  median pixel is equal).  Held to: convergence flags equal on >= 99.9 %
  of pixels, every position within 1e-2 px, and 99 % within 1e-3 px.
* refine: equal integer positions against JAX
  ``refine_matches_dense_single`` (claim pass, dense stencil and loser
  drain), on random and on oracle descriptors, with a ``valid`` mask and
  with colliding centres.  Descriptor products of two bf16 values are
  exact in f32; only the order of the 24-term sums could differ, and on
  these inputs it does not change a pick.
* the single-level search of K3's plain version against the Pallas kernel
  itself, ``dense_best_pallas(interpret=True)``: every pixel queries its
  own centre, running max from -inf; ``best`` and ``bo`` must be equal.
* ``_match_cascade``: equal match indices on >= 99.9 % of pixels, equal
  validity.  Without descriptors (``match_pi3``) nothing snaps the
  truncated LM positions: within one pixel.
* K3 adds each product with an FMA: the premise that this is exact (a
  product of two bf16 values is exact in f32, so an FMA rounds as the
  plain version's multiply and add do) is checked here on bf16 values as
  far as 2^-20 and 2^20 apart.
* the f32 search (``compute_dtype`` None): K3's f32 instance (its plain
  version here) against JAX's ``_refine_single``; equal positions on the
  random cases, and on an oracle pair >= 99.9 % with near-ties checked.
* on the card (``cuda`` marker): K3 and its f32 instance against their
  plain version, exactly, at every radius K3 is built for; other radii
  raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.ops import matching as jm
from artdeco_tpu.ops.refine_dense import refine_matches_dense_single
from artdeco_tpu.ops.refine_pallas import dense_best_pallas
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.ops import matching as M
from artdeco_tpu_torch.ops import refine_dense as RD
from torch_parity import n, t, torch_threads  # noqa: F401

jrefine = jax.jit(refine_matches_dense_single,
                  static_argnames=("radius", "dilation_max", "interpret"))
MATCH_CFG = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-6, dist_thresh=0.1,
                 radius=4, dilation_max=5)


def oracle_pair(h=48, w=64, shift=3):
    """(X11, X21, D11, D21) of two frames of the oracle's plane scene
    ``shift`` stream frames apart (0.02 m each), from the oracle's numpy
    geometry: X21 is frame 2's points in frame 1's camera.  (The port's
    copy, which tests/test_torch_frontend.py holds to the JAX package's:
    this file imports no JAX model code, so its ``cuda`` test also runs
    where flax is not installed.)"""
    K = np.asarray([[0.8 * w, 0, (w - 1) / 2], [0, 0.8 * w, (h - 1) / 2], [0, 0, 1]],
                   np.float32)
    r = OracleRunner((h, w), K, MATCH_CFG, device="cpu")
    for i in (0, shift):
        T = np.asarray([0.02 * i, 0, 0, 0, 0, 0, 1, 1], np.float32)
        r._poses[i] = T
    X11 = r._pointmap(0).reshape(1, h, w, 3)
    # frame `shift`'s world points in frame 0's camera (pose 0 is identity)
    X21 = r._np_sim3_act(r._poses[shift], r._pointmap(shift)).reshape(1, h, w, 3)
    D11 = r._desc(0).reshape(1, h, w, -1)
    D21 = r._desc(shift).reshape(1, h, w, -1)
    return X11, X21, D11, D21


def test_img_gradient_and_prep_match_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 10, 13).astype(np.float32)
    for x in (img, img[0]):
        for a, b in zip(M.img_gradient(t(x)), jm.img_gradient(jnp.asarray(x))):
            np.testing.assert_allclose(n(a), n(b), atol=1e-6)
    X11, X21, _, _ = oracle_pair(12, 16)
    init = rng.randint(0, 12 * 16, size=(1, 12 * 16))
    for idx in (None, init):
        ta = M.prep_for_iter_proj(t(X11), t(X21), None if idx is None else t(idx))
        ja = jm.prep_for_iter_proj(jnp.asarray(X11), jnp.asarray(X21),
                                   None if idx is None else jnp.asarray(idx))
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(n(a), n(b), atol=1e-6)


@pytest.mark.parametrize("shift", [1, 3])
def test_iter_proj_matches_jax(shift):
    X11, X21, _, _ = oracle_pair(shift=shift)
    rays, pts, p_init = jm.prep_for_iter_proj(jnp.asarray(X11), jnp.asarray(X21), None)
    jp, jc = jm.iter_proj(rays, pts, p_init, max_iter=10, lambda_init=1e-8,
                          cost_thresh=1e-6)
    tp, tc = M.iter_proj(t(rays), t(pts), t(p_init), max_iter=10, lambda_init=1e-8,
                         cost_thresh=1e-6)
    d = np.abs(n(jp) - n(tp)).max(-1)
    assert d.max() <= 1e-2, d.max()
    assert (d <= 1e-3).mean() >= 0.99, (d <= 1e-3).mean()
    assert (n(tc) == n(jc)).mean() >= 0.999


def refine_cases():
    rng = np.random.RandomState(1)
    h, w = 20, 28
    X11, X21, D11o, D21o = oracle_pair(h, w, shift=2)
    D11r = rng.randn(h, w, 24).astype(np.float32)
    D21r = rng.randn(h * w, 24).astype(np.float32)
    p_rand = rng.randint(0, [w, h], size=(h * w, 2)).astype(np.int32)
    # colliding centres: every query starts at one of 12 positions
    p_coll = p_rand[rng.randint(0, 12, size=h * w)]
    # oracle queries start at the pixel they came from
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    p_id = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.int32)
    valid = rng.rand(h * w) > 0.25
    return {
        "random": (D11r, D21r, p_rand, valid),
        "random-colliding": (D11r, D21r, p_coll, valid),
        "random-all-valid": (D11r, D21r, p_coll, None),
        "oracle": (D11o[0], D21o[0].reshape(h * w, -1), p_id, valid),
        "oracle-colliding": (D11o[0], D21o[0].reshape(h * w, -1), p_coll, None),
    }


CASES = refine_cases()


@pytest.mark.parametrize("radius,dilation_max", [(2, 2), (4, 3), (4, 5)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_refine_equals_jax_dense_single(case, radius, dilation_max):
    D11, D21, p1, valid = CASES[case]
    # JAX's valid=None means all valid; one signature keeps one compile
    jvalid = np.ones(len(p1), bool) if valid is None else valid
    jp, dropped = jrefine(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p1),
                          radius=radius, dilation_max=dilation_max,
                          valid=jnp.asarray(jvalid))
    assert int(dropped) == 0
    tp = RD.refine_matches_dense_single(t(D11), t(D21), t(p1), radius=radius,
                                        dilation_max=dilation_max,
                                        valid=None if valid is None else t(valid))
    np.testing.assert_array_equal(n(tp), n(jp))
    if valid is not None:       # invalid queries keep their position
        np.testing.assert_array_equal(n(tp)[~valid], p1[~valid])


@pytest.mark.parametrize("d", [1, 2, 5])
def test_single_level_search_equals_pallas_kernel(d):
    """K3's plain version, one level, every pixel at its own centre with the
    running max at -inf, against the TPU kernel run in interpret mode."""
    rng = np.random.RandomState(2)
    h, w, f, radius = 16, 24, 24, 4
    span, rd = 2 * radius + 1, radius * d
    D11 = jnp.asarray(rng.randn(h, w, f).astype(np.float32)).astype(jnp.bfloat16)
    D21 = jnp.asarray(rng.randn(h * w, f).astype(np.float32)).astype(jnp.bfloat16)
    Ppad = jnp.pad(jnp.transpose(D11, (2, 0, 1)), ((0, 0), (rd, rd), (rd, rd)))
    G = jnp.transpose(D21.reshape(h, w, f), (2, 0, 1))
    best, bo = dense_best_pallas(Ppad, G, span=span, d=d, interpret=True)
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    p = t(np.stack([uu.ravel(), vv.ravel()], -1), torch.int32)
    tb = t(np.asarray(D11.astype(jnp.float32))).to(torch.bfloat16)
    tq = t(np.asarray(D21.astype(jnp.float32))).to(torch.bfloat16)
    pn, score = RD.window_argmax(tb, tq, p, torch.ones(h * w, dtype=torch.bool), radius,
                                 d, d, float("-inf"))
    bi = (pn[:, 0] - p[:, 0] + rd) // d
    bj = (pn[:, 1] - p[:, 1] + rd) // d
    np.testing.assert_array_equal(n(score).reshape(h, w), n(best))
    np.testing.assert_array_equal(n(bi * span + bj).reshape(h, w), n(bo))


def test_bf16_rounding_matches_xla():
    """``.to(torch.bfloat16)`` rounds to nearest even, as XLA's convert."""
    x = np.random.RandomState(3).randn(4096).astype(np.float32)
    x[:4] = [1.00390625, 1.01171875, -1.00390625, 3.0e-39]     # ties and a denormal
    a = t(x).to(torch.bfloat16).float()
    b = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(n(a), np.asarray(b))


jrefine_f32 = jax.jit(jm.refine_matches, static_argnames=("radius", "dilation_max"))


def f32_scores(D11, D21, p1, radius, d):
    """Float64 scores of every query's window at dilation ``d`` around
    ``p1``: (n, span * span), zeros outside the image."""
    h, w, _ = D11.shape
    span = 2 * radius + 1
    out = np.zeros((len(p1), span * span))
    for i in range(span):
        for j in range(span):
            uu = p1[:, 0] - radius * d + i * d
            vv = p1[:, 1] - radius * d + j * d
            inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            s = np.sum(D11[vv.clip(0, h - 1), uu.clip(0, w - 1)].astype(np.float64)
                       * D21.astype(np.float64), axis=-1)
            out[:, i * span + j] = np.where(inside, s, 0.0)
    return out


def test_refine_f32_path_is_not_ported():
    """The f32 search (``compute_dtype`` None) was once refused; it is now
    K3's f32 instance.  Against JAX's ``_refine_single`` on the random
    cases (``valid`` given, and ignored by both): positions equal on every
    query (measured: all 560 of each case)."""
    for case in ("random", "random-colliding"):
        D11, D21, p1, valid = CASES[case]
        jp = jrefine_f32(jnp.asarray(D11)[None], jnp.asarray(D21)[None], jnp.asarray(p1)[None],
                         radius=4, dilation_max=3, compute_dtype=None)
        tp = M.refine_matches(t(D11)[None], t(D21)[None], t(p1)[None], radius=4,
                              dilation_max=3, compute_dtype=None, valid=t(valid)[None])
        np.testing.assert_array_equal(n(tp), n(jp))


def test_refine_f32_matches_jax_on_the_oracle_pair():
    """``refine_matches(compute_dtype=None)`` against JAX's ``_refine_single``
    on a 48x64 oracle pair at the stream's settings (radius 4, dilations
    5..1), every pixel starting at its own position.  The sums of 24
    float32 products run in channel order here and in XLA's order there,
    so a pick between two offsets whose scores differ by a few ulps may
    differ: positions equal on >= 99.9 % of the queries (measured: all
    3072), and where they differ the two picks score within 1e-5 of each
    other in float64 (a near-tie)."""
    X11, X21, D11, D21 = oracle_pair(48, 64, shift=3)
    h, w = 48, 64
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    p1 = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.int32)
    d11, d21 = D11[0], D21[0].reshape(h * w, -1)
    jp = n(jrefine_f32(jnp.asarray(d11)[None], jnp.asarray(d21)[None], jnp.asarray(p1)[None],
                       radius=4, dilation_max=5, compute_dtype=None))[0]
    before = RD.window_argmax.launches_f32
    tp = n(M.refine_matches(t(d11)[None], t(d21)[None], t(p1)[None], radius=4, dilation_max=5,
                            compute_dtype=None))[0]
    assert RD.window_argmax.launches_f32 == before      # the CPU runs the plain version
    same = np.all(tp == jp, axis=-1)
    assert same.mean() >= 0.999, same.mean()
    if not same.all():
        lin = lambda q: q[:, 1] * w + q[:, 0]                       # noqa: E731
        st = np.sum(d11.reshape(-1, 24)[lin(tp[~same])].astype(np.float64)
                    * d21[~same], axis=-1)
        sj = np.sum(d11.reshape(-1, 24)[lin(jp[~same])].astype(np.float64)
                    * d21[~same], axis=-1)
        np.testing.assert_allclose(st, sj, atol=1e-5)


@pytest.mark.parametrize("with_init", [False, True])
def test_match_cascade_matches_jax(with_init):
    X11, X21, D11, D21 = oracle_pair(shift=3)
    hw = X11.shape[1] * X11.shape[2]
    init = None
    if with_init:   # the previous frame's matches, as the tracker passes them
        init = np.asarray(jm.match(MATCH_CFG, *map(jnp.asarray, oracle_pair(shift=1)))[0])
    j_idx, j_valid = jm.match(MATCH_CFG, *map(jnp.asarray, (X11, X21, D11, D21)),
                              idx_1_to_2_init=None if init is None else jnp.asarray(init))
    t_idx, t_valid = M.match(MATCH_CFG, t(X11), t(X21), t(D11), t(D21),
                             idx_1_to_2_init=None if init is None else t(init))
    assert t_idx.shape == (1, hw) and t_valid.shape == (1, hw, 1)
    np.testing.assert_array_equal(n(t_valid), n(j_valid))
    assert (n(t_idx) == n(j_idx)).mean() >= 0.999
    assert n(t_valid).mean() > 0.5
    # the descriptor-free variant: no refine snaps the truncated iter_proj
    # positions, and where the true match lies on a pixel row (this motion
    # is along u) an ulp decides the row, so indices may differ by one row
    pi, pv = M.match_pi3(MATCH_CFG, t(X11), t(X21))
    ji, jv = jm.match_pi3(MATCH_CFG, jnp.asarray(X11), jnp.asarray(X21))
    w = X11.shape[2]
    assert pv.shape == (1, hw) and (n(pv) == n(jv)).mean() >= 0.999
    du = np.abs(n(pi) % w - n(ji) % w)
    dv = np.abs(n(pi) // w - n(ji) // w)
    assert du.max() <= 1 and dv.max() <= 1


def test_fma_chain_is_the_plain_score():
    """Random bf16 descriptors, a quarter of the channels scaled by 2^+-20
    or 2^+-19: every f32 product of two of them equals the float64 product,
    and the channel-order sum that adds each exact product in f32 (what
    K3's chain of fmaf computes) equals the plain version's score bit for
    bit, at every query of a radius-1 search (running max from -inf; out-
    of-image samples score 0)."""
    rng = np.random.default_rng(4)
    h, w, f, nq = 6, 7, 24, 64

    def bf16(shape):
        x = rng.normal(size=shape) * 2.0 ** rng.choice([-20, -19, 0, 19, 20], size=shape,
                                                       p=[0.125, 0.125, 0.5, 0.125, 0.125])
        return t(x.astype(np.float32)).to(torch.bfloat16)

    D11b, D21b = bf16((h, w, f)), bf16((nq, f))
    p = t(np.stack([rng.integers(0, w, nq), rng.integers(0, h, nq)], -1), torch.int32)
    r64, g64 = n(D11b.double()), n(D21b.double())
    # every (image row, query) pair, channel by channel
    a, b = n(D11b.float()).reshape(-1, 1, f), n(D21b.float())[None]
    np.testing.assert_array_equal((a * b).astype(np.float64),
                                  a.astype(np.float64) * b.astype(np.float64))

    u, v = n(p[:, 0]), n(p[:, 1])
    scores = np.zeros((nq, 9), np.float32)        # (i, j), i (u) outer
    for i in range(3):
        for j in range(3):
            uu, vv = u - 1 + i, v - 1 + j
            inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            prod = r64[vv.clip(0, h - 1), uu.clip(0, w - 1)] * g64   # exact
            s = np.zeros(nq, np.float32)
            for c in range(f):
                s = s + prod[:, c].astype(np.float32)            # one f32 rounding
            scores[:, 3 * i + j] = np.where(inside, s, np.float32(0.0))
    best = scores.argmax(-1)                      # the first max
    pp, sp = RD.window_argmax_plain(D11b, D21b, p, torch.ones(nq, dtype=torch.bool), 1, 1,
                                    1, float("-inf"))
    np.testing.assert_array_equal(n(sp).view(np.uint32),
                                  scores[np.arange(nq), best].view(np.uint32))
    np.testing.assert_array_equal(n(pp), np.stack([u - 1 + best // 3, v - 1 + best % 3], -1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("radius", RD.RADII)
def test_k3_matches_plain_version_on_card(cuda_device, radius):
    """K3 at each radius it is built for, bitwise equal to its plain
    version in positions and scores."""
    for case in ("random-colliding", "oracle"):
        D11, D21, p1, valid = CASES[case]
        valid = np.ones(len(p1), bool) if valid is None else valid
        args = [t(D11).to(torch.bfloat16), t(D21).to(torch.bfloat16), t(p1, torch.int32),
                t(valid)]
        before = RD.window_argmax.launches
        pk, sk = RD.window_argmax(*[a.to(cuda_device) for a in args], radius, 5)
        pp, sp = RD.window_argmax_plain(*args, radius, 5, 1, RD.FLT_MIN)
        torch.cuda.synchronize()
        assert RD.window_argmax.launches == before + 1
        np.testing.assert_array_equal(n(pk), n(pp))
        np.testing.assert_array_equal(n(sk).view(np.uint32), n(sp).view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", RD.RADII)
def test_k3_f32_matches_plain_version_on_card(cuda_device, radius):
    """K3's f32 instance at each radius, bitwise equal to its plain
    version (each product rounded before it is added, in channel order)."""
    for case in ("random-colliding", "oracle"):
        D11, D21, p1, _ = CASES[case]
        args = [t(D11), t(D21), t(p1, torch.int32), torch.ones(len(p1), dtype=torch.bool)]
        before = RD.window_argmax.launches_f32
        pk, sk = RD.window_argmax(*[a.to(cuda_device) for a in args], radius, 5)
        pp, sp = RD.window_argmax_plain(*args, radius, 5, 1, RD.FLT_MIN)
        torch.cuda.synchronize()
        assert RD.window_argmax.launches_f32 == before + 1
        np.testing.assert_array_equal(n(pk), n(pp))
        np.testing.assert_array_equal(n(sk).view(np.uint32), n(sp).view(np.uint32))


@pytest.mark.cuda
def test_k3_refuses_radii_it_is_not_built_for(cuda_device):
    D11, D21, p1, valid = CASES["random"]
    args = [t(D11).to(torch.bfloat16), t(D21).to(torch.bfloat16), t(p1, torch.int32),
            t(valid)]
    before = RD.window_argmax.launches
    with pytest.raises(ValueError, match="radii"):
        RD.window_argmax(*[a.to(cuda_device) for a in args], max(RD.RADII) + 1, 5)
    assert RD.window_argmax.launches == before
