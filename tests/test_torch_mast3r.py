"""The port's MASt3R (``artdeco_tpu_torch/models/mast3r.py``) and its runner
(``models/mast3r_infer.py``) against the JAX package's, on the CPU, at
``tiny_config``.

Weights cross by both routes: the torch-layout ``synth_state_dict``
loaded into the port by name (and converted into the JAX package by its
``convert_state_dict``), and a flax ``init`` carried into the port by
``state_dict_from_flax``.  Tolerances, in float32 (the measured gaps in
brackets): RoPE within 1e-5 [4e-7]; an encoder block, a decoder block,
the DPT head and the local-feature head within 1e-5 of each output's
largest magnitude [3e-7]; the full forward's points, confidences,
descriptors and descriptor confidences within 1e-5 of their largest
magnitude [2.2e-6 on descriptors]; the flax-init route the same.  In bf16
(the full model's compute dtype): points and confidences within 1e-4 of
their largest magnitude [1.2e-7], descriptors within 0.05 [0.016] and
descriptor confidences within 5e-3 relative [9e-4] -- the bf16 trunk rounds
differently in the two packages (bias before or after the product's
rounding, softmax probabilities rounded to bf16 or not).  The runner's
outputs within 1e-5 of their largest magnitude; its match validity agrees
on >= 99.9 % of pixels and its indices on >= 99.9 % of the pixels both
call valid, as ``iter_proj``'s do (ROADMAP section 3) [100 %].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.models import mast3r as JM
from artdeco_tpu.models.convert_mast3r import convert_state_dict, synth_state_dict
from artdeco_tpu.models.mast3r_infer import Mast3rRunner as JRunner
from artdeco_tpu_torch.models import mast3r as TM
from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner
from torch_parity import CPU, n, t, torch_threads  # noqa: F401

H, W = 48, 64
# random weights give no geometry: the occlusion gate (dist_thresh) would
# reject every pixel, so it is opened, and convergence is judged at 1e-4
MATCH = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-4, dist_thresh=1e9,
             radius=2, dilation_max=2)


def _cfgs(dtype="f32"):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return JM.tiny_config(compute_dtype=jd), TM.tiny_config(compute_dtype=td)


def _imgs(seed=0, b=1):
    rng = np.random.RandomState(seed)
    return [rng.rand(b, 3, H, W).astype(np.float32) * 2 - 1 for _ in range(2)]


def _close(got, want, rel=1e-5, err=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=rel * scale,
                               err_msg=err)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    sd = synth_state_dict(jcfg)
    params = convert_state_dict(sd, jcfg)
    return jcfg, tcfg, sd, params, TM.load_mast3r_state_dict(TM.MASt3R(tcfg), sd)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope2d_matches_jax(dtype):
    rng = np.random.RandomState(0)
    tok = rng.randn(2, 4, 12, 16).astype(np.float32)
    pos = np.stack(np.meshgrid(np.arange(3), np.arange(4), indexing="ij"), -1).reshape(1, 12, 2)
    pos = np.repeat(pos, 2, axis=0).astype(np.int32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    j = JM.rope2d(jnp.asarray(tok, jd), jnp.asarray(pos), 100.0, layout="bhnd")
    p = TM.rope2d(t(tok).to(td), t(pos).long(), 100.0)
    assert p.dtype == td
    _close(n(p.float()), np.asarray(j, np.float32), 1e-5 if dtype == "f32" else 1e-2)


def test_blocks_match_jax(models):
    jcfg, _, _, params, tm = models
    p = params["params"]
    rng = np.random.RandomState(1)
    nh, nw = H // 16, W // 16
    pos = np.stack(np.meshgrid(np.arange(nh), np.arange(nw), indexing="ij"), -1)
    pos = pos.reshape(1, nh * nw, 2).astype(np.int32)
    x = rng.randn(1, nh * nw, jcfg.enc_embed_dim).astype(np.float32)
    j = JM.EncoderBlock(jcfg.enc_embed_dim, jcfg.enc_num_heads, jcfg.mlp_ratio, jcfg.rope_freq,
                        jnp.float32).apply({"params": p["encoder"]["enc_block_1"]},
                                           jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = tm.enc_blocks[1](t(x), t(pos).long())
    _close(n(got), j, err="encoder block")
    x, y = (rng.randn(1, nh * nw, jcfg.dec_embed_dim).astype(np.float32) for _ in range(2))
    j = JM.DecoderBlock(jcfg.dec_embed_dim, jcfg.dec_num_heads, jcfg.mlp_ratio, jcfg.rope_freq,
                        jnp.float32).apply({"params": p["decoder"]["dec_block2_2"]},
                                           jnp.asarray(x), jnp.asarray(y), jnp.asarray(pos),
                                           jnp.asarray(pos))
    with torch.no_grad():
        got = tm.dec_blocks2[2](t(x), t(y), t(pos).long(), t(pos).long())
    _close(n(got), j, err="decoder block")


def test_heads_match_jax(models):
    """The DPT head (deconvolutions, align-corners upsampling, refinenet4's
    crop at an odd token grid) and the local-feature head's pixel shuffle."""
    jcfg, _, _, params, tm = models
    p = params["params"]
    rng = np.random.RandomState(2)
    nh, nw = 3, 5            # act4_conv2 halves 3x5 to 2x3: refinenet4 crops 4x6 to 3x5
    n_tok = nh * nw
    hooks = [rng.randn(1, n_tok, jcfg.enc_embed_dim).astype(np.float32)] + [
        rng.randn(1, n_tok, jcfg.dec_embed_dim).astype(np.float32) for _ in range(3)]
    j = JM.DPTHead(jcfg).apply({"params": p["head2_dpt"]}, [jnp.asarray(h) for h in hooks],
                               nh, nw)
    with torch.no_grad():
        got = tm.downstream_head2.dpt([t(h) for h in hooks], nh, nw).permute(0, 2, 3, 1)
    assert tuple(got.shape) == tuple(j.shape) == (1, 16 * nh, 16 * nw, 4)
    _close(n(got), j, err="DPT head")
    j = JM.LocalFeatHead(jcfg).apply({"params": p["head1_local"]}, jnp.asarray(hooks[0]),
                                     jnp.asarray(hooks[3]), nh, nw)
    with torch.no_grad():
        got = tm.downstream_head1.local_features(t(hooks[0]), t(hooks[3]), nh, nw, 16)
    _close(n(got), j, err="local head")


def _forward_both(jcfg, params, tm):
    i1, i2 = _imgs()
    jr = JM.MASt3R(jcfg).apply(params, jnp.asarray(i1), jnp.asarray(i2))
    with torch.no_grad():
        tr = tm(t(i1), t(i2))
    return jr, tr


@pytest.mark.parametrize("route", ["state_dict", "flax_init"])
def test_forward_matches_jax(models, route):
    jcfg, tcfg, _, params, tm = models
    if route == "flax_init":
        img = jnp.zeros((1, 3, H, W))
        params = JM.MASt3R(jcfg).init(jax.random.PRNGKey(3), img, img)
        tm = TM.load_mast3r_state_dict(TM.MASt3R(tcfg), TM.state_dict_from_flax(params, tcfg))
    jr, tr = _forward_both(jcfg, params, tm)
    for jres, tres in zip(jr, tr):
        for k in ("pts3d", "conf", "desc", "desc_conf"):
            assert tuple(tres[k].shape) == tuple(jres[k].shape)
            _close(n(tres[k]), jres[k], err=f"{route} {k}")


def test_forward_bf16_matches_jax():
    jcfg, tcfg = _cfgs("bf16")
    sd = synth_state_dict(jcfg)
    tm = TM.load_mast3r_state_dict(TM.MASt3R(tcfg), sd)
    assert tm.enc_blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert tm.enc_blocks[0].norm1.weight.dtype == torch.float32
    assert tm.downstream_head1.dpt.head[0].weight.dtype == torch.float32
    jr, tr = _forward_both(jcfg, convert_state_dict(sd, jcfg), tm)
    for jres, tres in zip(jr, tr):
        _close(n(tres["pts3d"]), jres["pts3d"], 1e-4, "pts3d")
        _close(n(tres["conf"]), jres["conf"], 1e-4, "conf")
        np.testing.assert_allclose(n(tres["desc"]), np.asarray(jres["desc"]), atol=0.05)
        np.testing.assert_allclose(n(tres["desc_conf"]), np.asarray(jres["desc_conf"]),
                                   rtol=5e-3)


def test_strict_loading():
    _, tcfg = _cfgs()
    sd = synth_state_dict(JM.tiny_config())
    dead = set(TM.DEAD_KEYS)
    assert len(dead) == 8 and dead <= set(sd)
    model = TM.MASt3R(tcfg)
    assert set(sd) - set(model.state_dict()) == dead
    assert set(model.state_dict()) <= set(sd)
    TM.load_mast3r_state_dict(model, sd)
    missing = dict(sd)
    missing.pop("enc_blocks.1.mlp.fc2.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        TM.load_mast3r_state_dict(TM.MASt3R(tcfg), missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        TM.load_mast3r_state_dict(TM.MASt3R(tcfg), dict(sd, mask_token=np.zeros(3, np.float32)))
    shared = {k: v for k, v in sd.items() if not k.startswith("dec_blocks2.")}
    m = TM.load_mast3r_state_dict(TM.MASt3R(tcfg), shared)
    np.testing.assert_array_equal(n(m.dec_blocks2[3].cross_attn.projk.weight),
                                  sd["dec_blocks.3.cross_attn.projk.weight"])


def _frames():
    """Two frames of the synthetic stream at 64x48, in [-1, 1]."""
    from artdeco_tpu_torch.dataio.dataset import SyntheticDataset

    ds = SyntheticDataset(type("A", (), {"test_hold": -1, "max_size_slam": W})(),
                          n_frames=4, width=W, height=H)
    return [ds.transform.to_slam(ds[i][0]) for i in (0, 3)]


def _same_matches(t_idx, t_valid, j_idx, j_valid, err=""):
    """Validity agrees on >= 99.9 % of pixels and the indices on >= 99.9 %
    of the pixels both packages call valid.  A random network's pointmap
    pair has no geometry: ``iter_proj`` converges on a few percent of the
    pixels, and the others end wherever ten LM steps leave them, which
    float32 rounding decides (fed the same pointmaps, the two packages'
    ``iter_proj`` put 0.2 % of such pixels at another integer position)."""
    tv, jv = n(t_valid).astype(bool).reshape(-1), np.asarray(j_valid).astype(bool).reshape(-1)
    assert np.mean(tv == jv) >= 0.999, err
    both = tv & jv
    assert both.sum() >= 50, err
    assert np.mean(n(t_idx).reshape(-1)[both] == np.asarray(j_idx).reshape(-1)[both]) >= 0.999, err


def test_runner_matches_jax(models):
    """``inference_mono``, ``match_asymmetric`` and ``match_symmetric``
    (two edges, both directions in one batched decode), with a flax
    ``init``'s weights: ``synth_state_dict``'s are so small that every
    pixel's point and descriptor are nearly equal, and the matches ties."""
    jcfg, tcfg, _, _, _ = models
    img = jnp.zeros((1, 3, H, W))
    params = JM.MASt3R(jcfg).init(jax.random.PRNGKey(3), img, img)
    jr = JRunner(jcfg, params, MATCH)
    tr = Mast3rRunner.create(tcfg, MATCH, state_dict=TM.state_dict_from_flax(params, tcfg),
                             device=CPU)
    f0, f1 = _frames()
    X, C, feat, pos = jr.inference_mono(jnp.asarray(f0))
    tX, tC, tfeat, tpos = tr.inference_mono(t(f0))
    _close(n(tX), X, err="mono X")
    _close(n(tC), C, err="mono C")
    _close(n(tfeat), feat, err="feat")
    np.testing.assert_array_equal(n(tpos), np.asarray(pos))

    jo = jr.match_asymmetric(jnp.asarray(f0), jnp.asarray(f1))
    to = tr.match_asymmetric(t(f0), t(f1))
    _same_matches(to[0], to[1], jo[0], jo[1], "asymmetric")
    for k in range(2, 8):
        _close(n(to[k]), jo[k], err=f"asymmetric output {k}")

    fi, pi = jr.encode_image(jnp.asarray(np.stack([f0, f1])))
    fj, pj = jr.encode_image(jnp.asarray(np.stack([f1, f0])))
    jo = jr.match_symmetric(fi, pi, fj, pj, (H, W))
    tfi, tpi = tr.encode_image(t(np.stack([f0, f1])))
    tfj, tpj = tr.encode_image(t(np.stack([f1, f0])))
    to = tr.match_symmetric(tfi, tpi, tfj, tpj, (H, W))
    for k in range(4):
        assert tuple(to[k].shape) == tuple(jo[k].shape)
    for e in range(2):
        _same_matches(to[0][e], to[2][e], jo[0][e], jo[2][e], f"edge {e} i<-j")
        _same_matches(to[1][e], to[3][e], jo[1][e], jo[3][e], f"edge {e} j<-i")
    for k in range(4, 8):
        _close(n(to[k]), jo[k], err=f"symmetric Q {k}")
