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


def _projected_sorted(seed):
    means, quats, scales, opac, _, view = _scene(seed)
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


def _slot_data(seed):
    """Slot matrix + runs built by the JAX binning, as the renderer packs
    them (channels: rgb, depth)."""
    m2d, conics, radii, opac = _projected_sorted(seed)
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


def test_composite_backward_matches_jax():
    sd, ps, pc, counts, tx, ty, _ = _slot_data(5)
    g_out = np.random.default_rng(6).normal(size=(tx * ty, 256, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: jcomp.tile_composite(s, jnp.asarray(ps), jnp.asarray(pc),
                                                    tx, ty), jnp.asarray(sd))
    (jg,) = vjp(jnp.asarray(g_out))
    ts = t(sd).requires_grad_()
    tcomp.tile_composite(ts, t(ps), t(pc), tx, ty).backward(t(g_out))
    # compare the slots of every run (JAX leaves the rest unwritten); the
    # port writes zeros outside the runs
    in_run = np.zeros(sd.shape[1], bool)
    for s0, c in zip(ps, pc):
        in_run[s0:s0 + c] = True
    tg, jg = n(ts.grad), n(jg)
    for rows, name in (([0, 1], "mean2d"), ([2, 3, 4], "conic"), ([5], "opacity"),
                       (list(range(8, 16)), "channels")):
        _close_rel(tg[rows][:, in_run], jg[rows][:, in_run], 1e-4, err_msg=name)
    assert (tg[:, ~in_run] == 0).all() and (tg[6:8] == 0).all()


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
                            torch.zeros(1, 256, 8, device="meta"))
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
    """K1/K2 against their plain PyTorch versions on the same card inputs.
    Forward 1e-4 absolute on RGB/alpha (products in another order); the
    backward sums each slot over 256 pixels in a fixed tree, the plain
    version in matmul order: 1e-3 relative to each group's largest entry."""
    sd, ps, pc, _, tx, ty, _ = _slot_data(9)
    sd, ps, pc = (x.to(cuda_device) for x in (t(sd), t(ps), t(pc)))
    f0, b0 = tcomp.composite_fwd.launches, tcomp.composite_bwd.launches
    out = tcomp.composite_fwd(sd, ps, pc, tx, ty)
    ref = tcomp.composite_fwd_plain(sd, ps, pc, tx, ty)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-4)
    g = torch.randn_like(out)
    gk = tcomp.composite_bwd(sd, ps, pc, tx, ty, g)
    gp = tcomp.composite_bwd_plain(sd, ps, pc, tx, ty, g)
    torch.cuda.synchronize()
    for rows in ([0, 1], [2, 3, 4], [5], list(range(8, 16))):
        _close_rel(gk[rows], gp[rows], 1e-3)
    assert tcomp.composite_fwd.launches == f0 + 1
    assert tcomp.composite_bwd.launches == b0 + 1
