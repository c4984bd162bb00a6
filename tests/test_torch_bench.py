"""The port's benchmark harness (``artdeco_tpu_torch/bench.py``) against the
repository's ``bench.py``, on the CPU.

* The golden check's scene (numpy draws) through the JAX package's tile
  binning and Pallas compositor (interpret mode, as tests/test_splat.py
  runs it) and its full-image reference, and through the port's plain
  versions: forward and the four gradients agree, and the port's
  ``golden_check`` passes on the CPU.
* The FLOPs ``bench_model`` divides by: ``FlopCounterMode``'s count for
  the tiny MASt3R against XLA's cost analysis of the JAX runner's
  ``_encode`` and ``_decode`` at the same shapes.
* ``bench_pipeline`` against ``bench.bench_pipeline`` (imported from the
  repository's root, unedited) at the same arguments: the same keyframe
  count after every frame and the same keyframe pose errors.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.ops.splat import binning as jbin
from artdeco_tpu.ops.splat import composite as jcomp
from artdeco_tpu_torch import bench
from torch_parity import CPU, n, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pipeline's test size: 14 frames (12 warm-up, 2 steady) at 256x144.
# bench.py fixes the SLAM stream at 512x288 and the mapper's slab at 2^17
# rows, which take the CPU minutes a frame; both packages run here with a
# 128-pixel SLAM stream (128x64) and a 2^12-row starting slab, which move
# neither the tracking nor the backend (the keyframe poses do not depend on
# the mapper)
PIPE_FRAMES, PIPE_W, PIPE_H, PIPE_SLAM = 14, 256, 144, 128
PIPE_MAPPER = dict(capacity=1 << 15, initial_capacity=1 << 12)

# bench.bench_pipeline of the JAX package in a subprocess on the CPU, with
# the SLAM size and the mapper sizes above patched in where it imports them
JAX_PIPELINE = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
sys.path.insert(0, {repo!r})
import bench
from artdeco_tpu.dataio import dataset as D
from artdeco_tpu.mapper import config as MC


class SlamSized(D.SyntheticDataset):
    def __init__(self, args, **kw):
        args.max_size_slam = {slam}
        super().__init__(args, **kw)


D.SyntheticDataset = SlamSized
_cfg = MC.MapperConfig
MC.MapperConfig = lambda **kw: _cfg(**{{**kw, **{mapper!r}}})
bench.bench_pipeline({frames}, {w}, {h})
"""


def _jax_tile_render(scene, means2d, conics, opac, channels):
    """bench.py's tile_render on the JAX package's binning and compositor."""
    w, h = scene["width"], scene["height"]
    num, c = channels.shape
    tx, ty = -(-w // jbin.TILE), -(-h // jbin.TILE)
    bins = jbin.build_tile_bins(means2d, jnp.asarray(scene["radii"]), tx, ty, kx=4, ky=4)
    packed = jnp.concatenate([means2d, conics, opac[:, None], jnp.zeros((num, 2)), channels,
                              jnp.zeros((num, jcomp.C_MAX - c))], axis=-1)
    slot_data = jnp.where(bins.slot_valid[None, :], packed.T[:, bins.slot_gauss], 0.0)
    out = jcomp.tile_composite(slot_data, bins.pad_starts, bins.pad_counts, tx, ty)
    img = (out.reshape(ty, tx, 16, 16, jcomp.C_MAX).transpose(0, 2, 1, 3, 4)
           .reshape(ty * 16, tx * 16, jcomp.C_MAX))[:h, :w]
    return img[..., :c], img[..., jcomp.C_MAX - 1]


def test_golden_scene_matches_jax_and_the_check_passes_on_the_cpu():
    """Tolerances: the forward within 1e-6 absolute (values of order 1;
    measured 1.2e-7 between the packages), each gradient within 1e-5 of its
    largest entry (float32 sums in another order)."""
    scene = bench.golden_scene()
    keys = ("means2d", "conics", "opac", "channels")
    args = [jnp.asarray(scene[k]) for k in keys]
    w, h = scene["width"], scene["height"]
    g_img, g_alpha = jnp.asarray(scene["g_img"]), jnp.asarray(scene["g_alpha"])

    def jloss(render):
        def f(*p):
            img, alpha = render(*p)
            return jnp.sum(img * g_img) + jnp.sum(alpha * g_alpha)
        return f

    def jtile(*p):
        return _jax_tile_render(scene, *p)

    def jref(*p):
        return jcomp.composite_reference(*p, w, h)

    j_img, j_alpha = jtile(*args)
    jr_img, jr_alpha = jref(*args)
    j_grads = jax.grad(jloss(jtile), argnums=(0, 1, 2, 3))(*args)
    jr_grads = jax.grad(jloss(jref), argnums=(0, 1, 2, 3))(*args)

    params = [torch.tensor(scene[k], requires_grad=True) for k in keys]
    t_img, t_alpha = bench.tile_render(*params, torch.tensor(scene["radii"]), w, h)
    t_grads = torch.autograd.grad((t_img * torch.tensor(scene["g_img"])).sum()
                                  + (t_alpha * torch.tensor(scene["g_alpha"])).sum(), params)
    ref_params = [torch.tensor(scene[k], requires_grad=True) for k in keys]
    from artdeco_tpu_torch.ops.splat import composite as tcomp
    tr_img, tr_alpha = tcomp.composite_reference(*ref_params, w, h)

    for a, b in ((t_img, j_img), (t_alpha, j_alpha), (tr_img, jr_img), (tr_alpha, jr_alpha)):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)
    for name, a, b in zip(keys, t_grads, j_grads):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-5 * np.abs(n(b)).max(),
                                   err_msg=name)
    # the JAX package's own golden errors are the port's, within the gates
    j_fwd = max(float(jnp.abs(j_img - jr_img).max()), float(jnp.abs(j_alpha - jr_alpha).max()))
    j_bwd = max(float(jnp.abs(a - b).max() / (jnp.abs(b).max() + 1e-6))
                for a, b in zip(j_grads, jr_grads))
    assert j_fwd < bench.GOLDEN_FWD_TOL and j_bwd < bench.GOLDEN_BWD_TOL
    errs = bench.golden_check(CPU)
    assert errs["fwd_err"] < bench.GOLDEN_FWD_TOL and errs["bwd_err"] < bench.GOLDEN_BWD_TOL
    assert abs(errs["fwd_err"] - j_fwd) < 1e-6 and abs(errs["bwd_err"] - j_bwd) < 1e-5


def test_model_flops_against_xla_cost_analysis():
    """``bench.model_flops`` counts matmuls, convolutions and attention;
    XLA's cost analysis also counts elementwise work.  Measured on the tiny
    MASt3R at 64x96: the port's count is 0.809 of XLA's for the encode
    (7,372,800 against 9,114,824: the patch embedding, the norms and RoPE
    are a large share of so small an encoder) and 0.996 for the decode with
    heads (302,389,248 against 303,628,544), 0.990 in all; pinned within
    0.78-0.84, 0.98-1.0 and 0.97-1.0."""
    from artdeco_tpu.models import mast3r as JM
    from artdeco_tpu.models.mast3r_infer import Mast3rRunner as JRunner
    from artdeco_tpu_torch.models import mast3r as TM
    from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner

    h, w = 64, 96
    cfg = JM.tiny_config()
    model = JM.MASt3R(cfg)
    zeros = jnp.zeros((1, 3, h, w))
    # shapes only: XLA's cost analysis needs no weights
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), zeros, zeros))
    jr = JRunner(cfg, params, {})
    img = jax.ShapeDtypeStruct((1, 3, h, w), jnp.float32)
    feat, pos = jax.eval_shape(jr._encode, params, img)
    costs = []
    for lowered in (jr._encode.lower(params, img),
                    jr._decode.lower(params, feat, pos, feat, pos, h // 16, w // 16)):
        c = lowered.compile().cost_analysis()
        costs.append((c[0] if isinstance(c, list) else c)["flops"])

    runner = Mast3rRunner.create(TM.tiny_config(compute_dtype=torch.float32), device=CPU)
    x = torch.zeros(1, 3, h, w)
    f, p = runner.encode_image(x)
    enc, dec = bench.model_flops(runner, x, f, p, f, p, (h, w))
    assert 0.78 < enc / costs[0] < 0.84, (enc, costs[0])
    assert 0.98 < dec / costs[1] <= 1.0, (dec, costs[1])
    assert 0.97 < (enc + dec) / sum(costs) <= 1.0


def _frames_kf(log: str) -> list:
    return [int(k) for k in re.findall(r"^  frame \d+: .*kf=(\d+)$", log, re.M)]


def _max_pose_err(log: str) -> float:
    return float(re.search(r"keyframe pose error vs GT: max ([0-9.]+)", log).group(1))


def test_bench_pipeline_matches_jax(capfd, tmp_path, monkeypatch):
    """The JAX package's bench_pipeline runs in a subprocess while the
    port's runs here.  Both must add their keyframes after the same frames
    (JAX's ``kf=`` lines against the port's), keep the max keyframe pose
    error under bench.py's 0.05, and agree on it within 1e-4; the port's
    returned counts must be its log's.  Both run at the sizes above,
    patched in where each reads its settings."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = JAX_PIPELINE.format(repo=REPO, slam=PIPE_SLAM, mapper=PIPE_MAPPER,
                               frames=PIPE_FRAMES, w=PIPE_W, h=PIPE_H)
    with open(tmp_path / "jax.log", "w") as out:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                stdout=out, stderr=subprocess.STDOUT)
    args, cfg = bench.pipeline_args(), bench.pipeline_mapper_config()
    args.max_size_slam = PIPE_SLAM
    monkeypatch.setattr(bench, "pipeline_args", lambda: args)
    monkeypatch.setattr(bench, "pipeline_mapper_config", lambda: cfg._replace(**PIPE_MAPPER))
    try:
        record = {}
        t_pipe, n_gauss, stages, spike, n_kf, max_err = bench.bench_pipeline(
            PIPE_FRAMES, PIPE_W, PIPE_H, device=CPU, record=record)
        port_log = capfd.readouterr().err
        proc.wait(timeout=600)
    finally:
        proc.kill()
    jax_log = (tmp_path / "jax.log").read_text()
    assert proc.returncode == 0, jax_log[-3000:]
    assert "slam 128x64" in jax_log and "slam 128x64" in port_log

    kf_jax, kf_port = _frames_kf(jax_log), _frames_kf(port_log)
    assert len(kf_jax) == len(kf_port) == PIPE_FRAMES
    assert kf_port == kf_jax == record["kf_after_frame"]
    assert kf_port[-1] == n_kf > 1
    err_jax = _max_pose_err(jax_log)
    assert max_err < bench.POSE_ERR_MAX and err_jax < bench.POSE_ERR_MAX
    assert abs(max_err - err_jax) < 1e-4
    assert n_gauss > 0 and t_pipe > 0 and set(stages) == {"track", "backend", "map"}
    assert record["keyframes"] == n_kf and record["max_pose_err"] == max_err
    # on the CPU the wrappers take their plain versions: nothing is launched
    assert record["launches"] == {"fwd": 0, "bwd": 0, "k3": 0}
    assert record["calls"]["steps"] > 0 and record["calls"]["tracked"] == PIPE_FRAMES - 1


def test_bench_entry_point_needs_a_card():
    """``python -m artdeco_tpu_torch.bench`` without a CUDA device exits
    non-zero and prints no result line."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "artdeco_tpu_torch.bench"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.golden_check()
