"""Parity of the PyTorch splat rasterizer with the JAX one, on the CPU.

The same numpy inputs go through ``artdeco_tpu.ops.splat`` (the Pallas
compositor in interpret mode, as tests/test_splat.py runs it) and through
``artdeco_tpu_torch.ops.splat`` (the compositor's plain PyTorch versions,
which the wrappers take for CPU tensors).  The CUDA kernels themselves are
compared with those plain versions on the card (``cuda`` marker).

Tolerances: float32 sums in another order (XLA's fused loops and dots
against eager torch ops) differ by a few ulps per term; 1e-5 absolute on
values of order 1, 1e-4 relative to each gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.ops.splat import api as japi
from artdeco_tpu.ops.splat import binning as jbin
from artdeco_tpu.ops.splat import composite as jcomp
from artdeco_tpu.ops.splat import project as jproj
from artdeco_tpu.ops.splat import sh as jsh
from artdeco_tpu_torch.ops.splat import api as tapi
from artdeco_tpu_torch.ops.splat import binning as tbin
from artdeco_tpu_torch.ops.splat import composite as tcomp
from artdeco_tpu_torch.ops.splat import project as tproj
from artdeco_tpu_torch.ops.splat import sh as tsh
from torch_parity import n, t, torch_threads  # noqa: F401

W, H = 64, 48
K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)


def _close_rel(a, b, rel, err_msg=""):
    """|a - b| <= rel * max|b| elementwise (gradients: error relative to
    the largest entry, since near-zero entries carry cancellation noise)."""
    b = n(b)
    a = np.zeros_like(b) if a is None else n(a)  # torch: None = no dependence
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-12),
                               err_msg=err_msg)


def _scene(seed, num=300, sh_k=4):
    rng = np.random.default_rng(seed)
    means = np.c_[rng.uniform(-1, 1, num), rng.uniform(-0.7, 0.7, num),
                  rng.uniform(1.5, 3, num)].astype(np.float32)
    # a few behind the camera and far off-screen: culling paths
    means[:5, 2] = -1.0
    means[5:8, 0] = 30.0
    quats = rng.normal(size=(num, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-4, -2.5, (num, 3))).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, num).astype(np.float32)
    cols = (rng.normal(size=(num, sh_k, 3)) * 0.3).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.05, -0.02, 0.1]
    c, s = np.cos(0.1), np.sin(0.1)
    view[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return means, quats, scales, opac, cols, view


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs[0] = 0.0  # the eps inside the rsqrt keeps this finite
    coeffs = rng.normal(size=(50, 16, 3)).astype(np.float32)
    w = rng.normal(size=(50, 3)).astype(np.float32)

    def jf(d, c):
        return jnp.sum(jsh.sh_to_color(degree, d, c) * w)

    jval = jsh.sh_to_color(degree, dirs, coeffs)
    jg = jax.grad(jf, argnums=(0, 1))(dirs, coeffs)
    td, tc = t(dirs).requires_grad_(), t(coeffs).requires_grad_()
    out = tsh.sh_to_color(degree, td, tc)
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(n(out), n(jval), atol=1e-5)
    _close_rel(td.grad, jg[0], 1e-5)
    _close_rel(tc.grad, jg[1], 1e-5)
    np.testing.assert_allclose(n(tsh.rgb_to_sh(t(w))), n(jsh.rgb_to_sh(w)), atol=1e-6)
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)


@pytest.mark.parametrize("antialiased", [False, True])
def test_projection_matches_jax(antialiased):
    means, quats, scales, _, _, view = _scene(1)
    rng = np.random.default_rng(2)
    wm, wc, wd, wk = (rng.normal(size=s).astype(np.float32)
                      for s in ((300, 2), (300, 3), (300,), (300,)))
    kw = dict(eps2d=0.3, antialiased=antialiased)

    def loss(p):
        # culled rows keep finite conics; weight only what the renderer uses
        return (jnp.sum(p.means2d * wm) + jnp.sum(jnp.tanh(p.conics) * wc)
                + jnp.sum(p.depths * wd) + jnp.sum(p.compensations * wk))

    jp = jproj.project_gaussians(means, quats, scales, view, K, W, H, **kw)
    jg = jax.grad(lambda *a: loss(jproj.project_gaussians(*a, K, W, H, **kw)),
                  argnums=(0, 1, 2, 3))(means, quats, scales, view)
    ts = [t(x).requires_grad_() for x in (means, quats, scales, view)]
    tp = tproj.project_gaussians(*ts, t(K), W, H, **kw)
    tl = ((tp.means2d * t(wm)).sum() + (torch.tanh(tp.conics) * t(wc)).sum()
          + (tp.depths * t(wd)).sum() + (tp.compensations * t(wk)).sum())
    tl.backward()
    for name in ("means2d", "depths", "compensations"):
        np.testing.assert_allclose(n(getattr(tp, name)), n(getattr(jp, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(n(tp.conics), n(jp.conics), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(n(tp.radii), n(jp.radii))
    assert (n(tp.radii)[:5] == 0).all() and (n(tp.radii)[5:8] == 0).all()
    for x, g, name in zip(ts, jg, ("means", "quats", "scales", "viewmat")):
        _close_rel(x.grad, g, 1e-4, err_msg=name)
    # the 3D covariance helper: entries up to ~1e-2, a few ulps of which
    # is ~1e-9 absolute
    np.testing.assert_allclose(
        n(tproj.quat_scale_to_cov3d(t(quats), t(scales))),
        n(jproj.quat_scale_to_cov3d(quats, scales)), rtol=1e-5, atol=1e-8)


def _projected_sorted(seed, num=300):
    means, quats, scales, opac, _, view = _scene(seed, num)
    p = jproj.project_gaussians(means, quats, scales, view, K, W, H, eps2d=0.3)
    order = np.argsort(np.asarray(p.depths), kind="stable")
    return (np.asarray(p.means2d)[order], np.asarray(p.conics)[order],
            np.asarray(p.radii)[order], opac[order])


def test_binning_matches_jax():
    """Same per-tile pair sets in the same (depth) order, same padded
    layout: the 4x4-tile footprint cap and the stable sort are kept."""
    m2d, _, radii, _ = _projected_sorted(3)
    radii = radii.copy()
    radii[10] = [200.0, 150.0]  # wider than 64 px: clipped to 4x4 tiles
    tx, ty = -(-W // 16), -(-H // 16)
    jb = jbin.build_tile_bins(jnp.asarray(m2d), jnp.asarray(radii), tx, ty)
    tb = tbin.build_tile_bins(t(m2d), t(radii), tx, ty)
    for name in ("pad_starts", "pad_counts", "tile_counts", "slot_valid"):
        np.testing.assert_array_equal(n(getattr(tb, name)), n(getattr(jb, name)),
                                      err_msg=name)
    valid = n(jb.slot_valid)
    np.testing.assert_array_equal(n(tb.slot_gauss)[valid], n(jb.slot_gauss)[valid])
    assert int(tb.num_pairs) == int(jb.num_pairs)
    assert tb.slot_gauss.shape[0] == tbin.num_slots(m2d.shape[0], tx * ty)
    assert (n(tb.slot_gauss) == 10).sum() <= 16
    # gauss_slots inverts slot_gauss: every valid slot once, under its gaussian
    gs = n(tb.gauss_slots)
    assert gs.shape == (m2d.shape[0], 16)
    g_of, s_of = np.nonzero(gs >= 0)
    slots = gs[g_of, s_of]
    assert len(slots) == int(tb.num_pairs) == valid.sum()
    np.testing.assert_array_equal(np.sort(slots), np.nonzero(valid)[0])
    np.testing.assert_array_equal(n(tb.slot_gauss)[slots], g_of)


def test_slot_gather_backward_is_the_scatter_add():
    """The gather's fixed-order backward equals autograd's scatter-add
    (index_select's backward) over the same slots, to float32 rounding of
    sums of at most 16 terms."""
    m2d, _, radii, _ = _projected_sorted(3)
    tb = tbin.build_tile_bins(t(m2d), t(radii), -(-W // 16), -(-H // 16))
    rng = np.random.default_rng(11)
    packed = t(rng.normal(size=(m2d.shape[0], 16)).astype(np.float32))
    g = t(rng.normal(size=(16, tb.slot_gauss.shape[0])).astype(np.float32))
    a = packed.clone().requires_grad_()
    out = tapi.SlotGather.apply(a, tb.slot_gauss, tb.slot_valid, tb.gauss_slots)
    out.backward(g)
    b = packed.clone().requires_grad_()
    ref = torch.where(tb.slot_valid[None], b.index_select(0, tb.slot_gauss).T, 0.0)
    ref.backward(g)
    np.testing.assert_array_equal(n(out), n(ref))
    np.testing.assert_allclose(n(a.grad), n(b.grad), rtol=0, atol=1e-5)
    assert (n(a.grad)[n(tb.gauss_slots).max(1) < 0] == 0).all()


def _slot_data(seed, num=300):
    """Slot matrix + runs built by the JAX binning, as the renderer packs
    them (channels: rgb, depth)."""
    m2d, conics, radii, opac = _projected_sorted(seed, num)
    rng = np.random.default_rng(seed + 100)
    ch = rng.uniform(size=(m2d.shape[0], 4)).astype(np.float32)
    tx, ty = -(-W // 16), -(-H // 16)
    bins = jbin.build_tile_bins(jnp.asarray(m2d), jnp.asarray(radii), tx, ty)
    packed = np.concatenate([m2d, conics, opac[:, None], np.zeros((len(opac), 2)),
                             ch, np.zeros((len(opac), 4))], -1).astype(np.float32)
    sd = np.where(n(bins.slot_valid)[None], packed.T[:, n(bins.slot_gauss)], 0.0)
    return (sd.astype(np.float32), n(bins.pad_starts), n(bins.pad_counts),
            n(bins.tile_counts), tx, ty, (m2d, conics, opac, ch))


def test_composite_forward_matches_jax():
    sd, ps, pc, _, tx, ty, (m2d, conics, opac, ch) = _slot_data(4)
    jout = jcomp.tile_composite(jnp.asarray(sd), jnp.asarray(ps), jnp.asarray(pc), tx, ty)
    tout = tcomp.tile_composite(t(sd), t(ps), t(pc), tx, ty)
    np.testing.assert_allclose(n(tout), n(jout), atol=1e-5)
    assert tcomp.composite_fwd.launches == 0  # CPU tensors: plain version
    # and the full-image reference compositor of both packages
    img = n(tout).reshape(ty, tx, 16, 16, 8).transpose(0, 2, 1, 3, 4).reshape(
        ty * 16, tx * 16, 8)[:H, :W]
    ref, ref_a = tcomp.composite_reference(t(m2d), t(conics), t(opac), t(ch), W, H)
    jref, jref_a = jcomp.composite_reference(m2d, conics, opac, ch, W, H)
    np.testing.assert_allclose(n(ref), n(jref), atol=1e-5)
    np.testing.assert_allclose(n(ref_a), n(jref_a), atol=1e-5)
    np.testing.assert_allclose(img[..., :4], n(ref), atol=2e-5)
    np.testing.assert_allclose(img[..., 7], n(ref_a), atol=2e-5)


def _in_run(ps, pc, S):
    in_run = np.zeros(S, bool)
    for s0, c in zip(ps, pc):
        in_run[s0:s0 + c] = True
    return in_run


def _backward_matches_jax(sd, ps, pc, tx, ty, seed):
    g_out = np.random.default_rng(seed).normal(size=(tx * ty, 256, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: jcomp.tile_composite(s, jnp.asarray(ps), jnp.asarray(pc),
                                                    tx, ty), jnp.asarray(sd))
    (jg,) = vjp(jnp.asarray(g_out))
    ts = t(sd).requires_grad_()
    tcomp.tile_composite(ts, t(ps), t(pc), tx, ty).backward(t(g_out))
    # compare the slots of every run (JAX leaves the rest unwritten); the
    # port writes zeros outside the runs
    in_run = _in_run(ps, pc, sd.shape[1])
    tg, jg = n(ts.grad), n(jg)
    for rows, name in (([0, 1], "mean2d"), ([2, 3, 4], "conic"), ([5], "opacity"),
                       (list(range(8, 16)), "channels")):
        _close_rel(tg[rows][:, in_run], jg[rows][:, in_run], 1e-4, err_msg=name)
    assert (tg[:, ~in_run] == 0).all() and (tg[6:8] == 0).all()


def test_composite_backward_matches_jax():
    sd, ps, pc, counts, tx, ty, _ = _slot_data(5)
    _backward_matches_jax(sd, ps, pc, tx, ty, 6)


def _tile_gaussians(rng, n, tile, opacity, sigma):
    """n screen-space Gaussians around tile (column) ``tile`` of a one-row
    grid, as slot columns (16, n): rgb + depth channels, sheared conics."""
    cols = np.zeros((16, n), np.float32)
    cols[0] = tile * 16 + rng.uniform(-4, 20, n)
    cols[1] = rng.uniform(-4, 20, n)
    sx = rng.uniform(*sigma, n)
    sy = sx * rng.uniform(0.7, 1.4, n)
    cols[2], cols[4] = 1 / sx**2, 1 / sy**2
    cols[3] = rng.uniform(-0.3, 0.3, n) / (sx * sy)
    cols[5] = rng.uniform(*opacity, n)
    cols[8:12] = rng.uniform(size=(4, n))
    return cols


def _edge_case(case):
    """A three-tile row whose tile ``k`` has the case's run; the others hold
    ordinary random Gaussians.  Runs are padded to whole chunks with empty
    slots and laid out in tile order, and (except for ``multi_chunk``, whose
    large run is the last of the matrix) one chunk outside every run
    follows.  Returns sd, starts, counts, tiles_x, tiles_y, k and the
    expected stop chunk of tile k given its chunk count."""
    rng = np.random.default_rng(sum(map(ord, case)))
    usual = dict(opacity=(0.2, 0.9), sigma=(2.0, 5.0))
    runs = [_tile_gaussians(rng, 100, 0, **usual), _tile_gaussians(rng, 200, 1, **usual),
            _tile_gaussians(rng, 60, 2, **usual)]
    k, tail = 0, 1
    if case == "empty_run":
        runs[0] = np.zeros((16, 0), np.float32)
        want = lambda stop, nch: stop == 0
    elif case == "stop_at_chunk_1":
        # four wide, nearly opaque Gaussians in front cover the whole tile
        front = _tile_gaussians(rng, 4, 0, opacity=(0.99, 0.99), sigma=(40.0, 60.0))
        runs[0] = np.concatenate([front, _tile_gaussians(rng, 380, 0, **usual)], 1)
        want = lambda stop, nch: stop == 1 and nch == 3
    elif case == "never_stops":
        runs[0] = _tile_gaussians(rng, 384, 0, opacity=(0.01, 0.04), sigma=(1.0, 2.0))
        want = lambda stop, nch: stop == nch == 3
    elif case == "one_sub_run":
        # every hit of chunk 0 lies in its third 32-slot sub-run, every hit
        # of chunk 1 in its first: K1 combines empty sub-runs around them
        runs[0] = np.zeros((16, 256), np.float32)
        runs[0][:, 64:96] = _tile_gaussians(rng, 32, 0, **usual)
        runs[0][:, 128:160] = _tile_gaussians(rng, 32, 0, **usual)
        want = lambda stop, nch: stop == nch == 2
    elif case == "alpha_clamp":
        # opaque Gaussians wide enough that alpha sits at the 0.999 clamp
        # over part of the tile, then ordinary ones
        front = _tile_gaussians(rng, 3, 0, opacity=(1.0, 1.0), sigma=(60.0, 120.0))
        runs[0] = np.concatenate([front, _tile_gaussians(rng, 380, 0, **usual)], 1)
        want = lambda stop, nch: 1 <= stop <= nch == 3
    elif case == "long_run":
        # six chunks of faint Gaussians: five votes, none stops the tile
        runs[0] = _tile_gaussians(rng, 700, 0, opacity=(0.01, 0.04), sigma=(1.0, 2.0))
        want = lambda stop, nch: stop == nch == 6
    else:  # multi_chunk: the vote stops inside a long run, the last of the matrix
        k, tail = 2, 0
        runs[2] = _tile_gaussians(rng, 768, 2, opacity=(0.1, 0.5), sigma=(1.5, 3.5))
        want = lambda stop, nch: 1 < stop < nch == 6
    counts = np.array([-(-r.shape[1] // 128) * 128 for r in runs], np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    sd = np.zeros((16, counts.sum() + tail * 128), np.float32)
    for r, s0 in zip(runs, starts):
        sd[:, s0:s0 + r.shape[1]] = r
    return sd, starts, counts, 3, 1, k, want


EDGE_CASES = ["empty_run", "stop_at_chunk_1", "never_stops", "multi_chunk",
              "one_sub_run", "alpha_clamp", "long_run"]


def _first_chunk_alpha(sd, ps, pc, tx, ty, k):
    """Alpha (PIX, CHUNK) of tile k's first chunk, by the plain version."""
    num_tiles = tx * ty
    px, py = tcomp._pix_coords(num_tiles, tx, "cpu")
    d, _ = tcomp._gather_chunk(t(sd), t(ps), 0, t(pc) > 0)
    return n(tcomp._chunk_alpha(d, px, py)[0][k])


@pytest.mark.parametrize("case", EDGE_CASES)
def test_composite_forward_edge_cases_match_jax(case):
    """The runs of K1's edge cases (a stop after the first chunk, hits in
    one 32-slot sub-run, alpha at the 0.999 clamp, runs of more than four
    chunks) composited by the plain version and by the Pallas kernel, with
    the expected stop chunk."""
    sd, ps, pc, tx, ty, k, want = _edge_case(case)
    tout, stop = tcomp.composite_fwd_plain(t(sd), t(ps), t(pc), tx, ty)
    assert want(int(stop[k]), int(pc[k]) // 128), (case, n(stop), pc)
    jout = jcomp.tile_composite(jnp.asarray(sd), jnp.asarray(ps), jnp.asarray(pc), tx, ty)
    np.testing.assert_allclose(n(tout), n(jout), atol=1e-5)
    if case == "one_sub_run":
        a = _first_chunk_alpha(sd, ps, pc, tx, ty, k)
        assert a[:, 64:96].max() > 0 and a[:, :64].max() == 0 and a[:, 96:].max() == 0
    if case == "alpha_clamp":
        a = _first_chunk_alpha(sd, ps, pc, tx, ty, k)
        assert (a == np.float32(tcomp.ALPHA_CLAMP)).sum() >= 10


@pytest.mark.parametrize("case", EDGE_CASES)
def test_composite_backward_edge_cases_match_jax(case):
    """Runs at the edges of K2's chunk decomposition, held to JAX
    ``_bwd_rule``: an empty run, a vote that stops after the first chunk,
    one that never stops, and a vote inside a long run that ends the
    matrix."""
    sd, ps, pc, tx, ty, k, want = _edge_case(case)
    _, stop = tcomp.composite_fwd_plain(t(sd), t(ps), t(pc), tx, ty)
    assert want(int(stop[k]), int(pc[k]) // 128), (case, n(stop), pc)
    _backward_matches_jax(sd, ps, pc, tx, ty, 12)


@pytest.mark.parametrize("sh_degree", [None, 1])
def test_rasterization_matches_jax(sh_degree):
    means, quats, scales, opac, cols, view = _scene(7)
    if sh_degree is None:
        cols = np.abs(cols[:, 0])
    rng = np.random.default_rng(8)
    mask = rng.uniform(size=len(opac)) > 0.1
    g_img = rng.normal(size=(H, W, 4)).astype(np.float32)
    g_a = rng.normal(size=(H, W, 1)).astype(np.float32)

    def jf(*args):
        r, a, _ = japi.rasterization(*args, jnp.asarray(K), W, H, sh_degree=sh_degree,
                                     eps2d=0.01, valid_mask=jnp.asarray(mask))
        return jnp.sum(r * g_img) + jnp.sum(a * g_a), (r, a)

    args = (means, quats, scales, opac, cols, view)
    (_, (jr, ja)), jg = jax.value_and_grad(jf, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, args))
    ts = [t(x).requires_grad_() for x in args]
    r, a, meta = tapi.rasterization(*ts, t(K), W, H, sh_degree=sh_degree, eps2d=0.01,
                                    valid_mask=t(mask))
    ((r * t(g_img)).sum() + (a * t(g_a)).sum()).backward()
    np.testing.assert_allclose(n(r), n(jr), atol=1e-5)
    np.testing.assert_allclose(n(a), n(ja), atol=1e-5)
    assert (n(meta.radii)[~mask] == 0).all()
    for x, g, name in zip(ts, jg, ("means", "quats", "scales", "opac", "colors",
                                   "viewmat")):
        _close_rel(x.grad, g, 1e-4, err_msg=name)


def test_wrappers_refuse_other_devices():
    """A wrapper runs the plain version only for CPU tensors; on any other
    device it launches its kernel or raises (no silent fallback)."""
    sd = torch.zeros(16, 256, device="meta")
    runs = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tcomp.composite_fwd(sd, runs, runs, 1, 1)
    with pytest.raises(ValueError):
        tcomp.composite_bwd(sd, runs, runs, 1, 1,
                            torch.zeros(1, 256, 8, device="meta"), runs)
    with pytest.raises(ValueError):  # layout checks before any launch
        tcomp.composite_fwd(torch.zeros(8, 256), torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), 1, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compositor kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda_device):
    """K1/K2 against their plain PyTorch versions on the same card inputs:
    a random scene, a dense one with multi-chunk runs, and the edge cases
    (K2's, and K1's: a stop after one chunk, hits in one sub-run, alpha at
    the clamp, a run of six chunks).
    Forward 1e-4 absolute on RGB/alpha (products in another order) and the
    same stop chunks; the backward, given K1's stop chunks, sums each slot
    over 256 pixels in a fixed tree, the plain version in matmul order:
    1e-3 relative to each group's largest entry.  Two K2 calls are bitwise
    equal, and each wrapper call counts one launch."""
    cases = [(sd, ps, pc, tx, ty) for sd, ps, pc, _, tx, ty, _ in
             (_slot_data(9), _slot_data(10, num=3000))]
    cases += [_edge_case(c)[:5] for c in EDGE_CASES]
    assert max(int(pc.max()) for _, _, pc, _, _ in cases[:2]) >= 3 * 128  # multi-chunk
    for sd, ps, pc, tx, ty in cases:
        sd, ps, pc = (x.to(cuda_device) for x in (t(sd), t(ps), t(pc)))
        f0, b0 = tcomp.composite_fwd.launches, tcomp.composite_bwd.launches
        out, stop = tcomp.composite_fwd(sd, ps, pc, tx, ty)
        ref, stop_ref = tcomp.composite_fwd_plain(sd, ps, pc, tx, ty)
        np.testing.assert_allclose(n(out), n(ref), atol=1e-4)
        np.testing.assert_array_equal(n(stop), n(stop_ref))
        g = torch.randn_like(out)
        gk = tcomp.composite_bwd(sd, ps, pc, tx, ty, g, stop)
        gk2 = tcomp.composite_bwd(sd, ps, pc, tx, ty, g, stop)
        gp = tcomp.composite_bwd_plain(sd, ps, pc, tx, ty, g, stop)
        torch.cuda.synchronize()
        for rows in ([0, 1], [2, 3, 4], [5], list(range(8, 16))):
            _close_rel(gk[rows], gp[rows], 1e-3)
        assert torch.equal(gk, gk2)
        in_run = _in_run(n(ps), n(pc), sd.shape[1])
        assert (n(gk)[:, ~in_run] == 0).all() and (n(gk)[6:8] == 0).all()
        assert tcomp.composite_fwd.launches == f0 + 1
        assert tcomp.composite_bwd.launches == b0 + 2


@pytest.mark.cuda
def test_kernels_launch_on_the_data_card(cuda_device):
    """K1 and K2 on cuda:1 while cuda:0 is the host thread's current device
    (a mesh slot on a second card): each wrapper launches on its data's
    card, and the results are the plain versions' there (the tolerances of
    ``test_kernels_match_plain_versions_on_card``)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    sd, ps, pc, _, tx, ty, _ = _slot_data(9)
    dev1 = torch.device("cuda", 1)
    sd, ps, pc = (x.to(dev1) for x in (t(sd), t(ps), t(pc)))
    with torch.cuda.device(0):
        out, stop = tcomp.composite_fwd(sd, ps, pc, tx, ty)
        g = torch.randn(out.shape, generator=torch.Generator(device=dev1).manual_seed(3),
                        device=dev1)
        gk = tcomp.composite_bwd(sd, ps, pc, tx, ty, g, stop)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev1)
    ref, stop_ref = tcomp.composite_fwd_plain(sd, ps, pc, tx, ty)
    gp = tcomp.composite_bwd_plain(sd, ps, pc, tx, ty, g, stop)
    assert out.device == gk.device == dev1
    np.testing.assert_allclose(n(out), n(ref), atol=1e-4)
    np.testing.assert_array_equal(n(stop), n(stop_ref))
    for rows in ([0, 1], [2, 3, 4], [5], list(range(8, 16))):
        _close_rel(gk[rows], gp[rows], 1e-3)
