"""The port's DepthAnythingV2 (``artdeco_tpu_torch/models/depth_anything.py``)
against the JAX package's, on the CPU.

Weights: the JAX test's release-layout random state dict (``synth_sd``),
converted for JAX and loaded strictly by the port, and a flax ``init``
carried across by ``state_dict_from_flax``.

Tolerances (the measured gaps in brackets): the ``tiny_dav2_config``
forward within 1e-4 of its largest magnitude, on a 6x6-patch image and
on a 4x7-patch one, where the position embedding's cubic resize shrinks
in both directions [< 1e-6]; ``make_dav2_model_fn`` at ``vits`` through
``MonoDepthEstimator`` on a 48x64 frame (56x70 into the net) within 1e-4
of the largest inverse depth [< 1e-6], the confidence within 1e-4 [< 1e-6].
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artdeco_tpu.mapper.mono_depth import MonoDepthEstimator as JMono
from artdeco_tpu.models import depth_anything as JD
from artdeco_tpu_torch.mapper.mono_depth import MonoDepthEstimator
from artdeco_tpu_torch.models import depth_anything as TD
from test_depth_anything import synth_sd
from torch_parity import CPU, n, t, torch_threads  # noqa: F401


def _close(a, b, rel=1e-4):
    a, b = n(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("patches", [(6, 6), (4, 7)])
def test_tiny_forward_matches_jax(patches):
    cfg = TD.tiny_dav2_config()
    sd = synth_sd(JD.tiny_dav2_config())
    model = TD.load_dav2_state_dict(TD.DepthAnythingV2(cfg), sd).eval()
    params = JD.convert_dav2_state_dict(sd, JD.tiny_dav2_config())
    h, w = (p * cfg.patch_size for p in patches)
    img = np.random.RandomState(0).rand(2, 3, h, w).astype(np.float32)
    with torch.no_grad():
        out = model(t(img))
    _close(out, JD.DepthAnythingV2(JD.tiny_dav2_config()).apply(params, jnp.asarray(img)))
    assert float(out.min()) >= 0.0


def test_flax_params_carry_across():
    jcfg = JD.tiny_dav2_config()
    jmodel = JD.DepthAnythingV2(jcfg)
    img = np.random.RandomState(1).rand(1, 3, 56, 56).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    # a non-zero cls position would be folded into the flax cls token
    params = jax.tree_util.tree_map(lambda x: x + 0.01, params)
    model = TD.load_dav2_state_dict(TD.DepthAnythingV2(TD.tiny_dav2_config()),
                                    TD.state_dict_from_flax(params, TD.tiny_dav2_config()))
    with torch.no_grad():
        out = model.eval()(t(img))
    _close(out, jmodel.apply(params, jnp.asarray(img)))


def test_release_state_dict_loads_strictly():
    cfg = TD.tiny_dav2_config()
    sd = synth_sd(JD.tiny_dav2_config())
    sd["pretrained.mask_token"] = np.zeros((1, cfg.embed_dim), np.float32)
    model = TD.load_dav2_state_dict(TD.DepthAnythingV2(cfg), sd)
    loaded = model.state_dict()
    assert set(loaded) == set(sd) - set(TD.IGNORED_KEYS)
    for k, v in loaded.items():
        np.testing.assert_array_equal(n(v), sd[k], err_msg=k)
    with pytest.raises(RuntimeError):
        TD.load_dav2_state_dict(TD.DepthAnythingV2(cfg),
                                {k: v for k, v in sd.items() if "blocks.1." not in k})


def test_vits_model_fn_through_mono_depth_matches_jax(tmp_path):
    sd = synth_sd(JD.dav2_config("vits"), seed=2)
    path = str(tmp_path / "depth_anything_v2_vits.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    img = np.random.RandomState(3).rand(3, 48, 64).astype(np.float32)
    jd, jc = JMono(JD.make_dav2_model_fn(path, encoder="vits", size=70))(img)
    fn = TD.make_dav2_model_fn(path, encoder="vits", size=70, device=CPU)
    td, tc = MonoDepthEstimator(fn)(img)
    assert td.shape == (48, 64) and tc.shape == (48, 64)
    _close(td, jd)
    np.testing.assert_allclose(tc, jc, atol=1e-4)


def test_random_full_model_fn_runs_on_the_requested_device():
    """``make_dav2_model_fn`` without weights: random, seeded, on the
    device asked for (a tiny image; the full ViT-L runs on the card)."""
    fn = TD.make_dav2_model_fn(encoder="vits", size=56, device=CPU, seed=1)
    assert next(fn.model.parameters()).device.type == "cpu"
    a = fn(np.random.RandomState(0).rand(3, 30, 40).astype(np.float32))
    b = TD.make_dav2_model_fn(encoder="vits", size=56, device=CPU, seed=1)(
        np.random.RandomState(0).rand(3, 30, 40).astype(np.float32))
    assert a.shape == (30, 40) and np.isfinite(a).all() and (a >= 0).all()
    np.testing.assert_array_equal(a, b)
