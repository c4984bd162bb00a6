"""The port's profilers (``artdeco_tpu_torch/scripts/profile_{stages,render,
refine}.py``, ``probe_transfers.py``) and ``SceneModel.optimization_step``,
on the CPU.

* ``optimization_step`` draws the same keyframes and backgrounds as the JAX
  package's on the mapper tests' plane scene, and N calls are
  ``optimization_loop(N)``, bit for bit.
* Each profiler's ``main(device=cpu)`` at a small size returns a row for
  every row its JAX counterpart prints: every ``timeit``/``log`` label of
  the JAX script is mapped here to the port's rows (or named progress), and
  a new JAX row fails the test until it is mapped.
* Without a card, every entry point raises.
"""

import ast
import dataclasses
import math
import os
import types

import numpy as np
import pytest
import torch

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.mapper import keyframe as JKF
from artdeco_tpu.mapper import scene_model as JS
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.runtime.system import _se3_w2c_matrix_np
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper import keyframe as TKF
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.scene_model import SceneModel
from artdeco_tpu_torch.runtime.system import exact_mapper_messages, se3_w2c_matrix_np
from artdeco_tpu_torch.scripts import (probe_transfers, profile_refine, profile_render,
                                       profile_stages)
from torch_parity import CPU, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
SIZES = dict(   # tests/test_torch_mapper.py's scene
    capacity=4096, cluster_capacity=1024, voxel_table_size=4096, new_budget=1024,
    keyframe_capacity=64, sh_degree=1, local_feat_dim=8, global_feat_dim=8,
    pyr_levels=2, gs_add_ratio=1.0, init_proba_scaler=4.0,
)
N_CALLS = 8


def _plane_scenes(n_frames: int = 3, seed: int = 0, jax_too: bool = True):
    """A port SceneModel (and the JAX package's) with ``n_frames`` keyframes
    of the plane stream, each densified."""
    args = types.SimpleNamespace(test_hold=0, max_size_slam=W)
    ds = SyntheticDataset(args, n_frames=n_frames, width=W, height=H)
    tsm = SceneModel(W, H, ds.K_map, MapperConfig(**SIZES), device=CPU, seed=seed)
    jsm = None
    if jax_too:
        jds = JSyntheticDataset(args, n_frames=n_frames, width=W, height=H)
        jsm = JS.SceneModel(W, H, jds.K_map, JMapperConfig(**SIZES), seed=seed)
    for m in exact_mapper_messages(ds, important_every=1):
        i = m["frame_id"]
        img = ds.transform.to_map(ds[i][0])
        tkf = TKF.make_device_keyframe(i, i, img, m["point_map"], m["point_conf"], False,
                                       m["is_slam_keyframe"], CPU,
                                       pyr_levels=SIZES["pyr_levels"])
        tsm.add_keyframe(tkf, se3_w2c_matrix_np(m["T_WC"][:7]))
        tsm.add_new_gaussians()
        if jsm is not None:
            jkf = JKF.make_device_keyframe(
                index=i, global_frame_id=i, image=jds.transform.to_map(jds[i][0]),
                point_map=m["point_map"], point_conf=m["point_conf"], is_test=False,
                is_slam_keyframe=m["is_slam_keyframe"], pyr_levels=SIZES["pyr_levels"])
            jsm.add_keyframe(jkf, _se3_w2c_matrix_np(m["T_WC"][:7]))
            jsm.add_new_gaussians()
    return tsm, jsm


def _record_port(sm, seen: list):
    step = sm.train_step

    def record(keyframe_id, bg, is_important):
        seen.append((keyframe_id, np.asarray(bg).copy()))
        return step(keyframe_id, bg, is_important)
    sm.train_step = record


def test_optimization_step_draws_as_jax(monkeypatch):
    """Over 8 calls on a 3-keyframe scene: the same keyframe ids and the
    same backgrounds (bitwise: both are the RandomState's float64 draws cast
    to float32), the same last trained id, the RandomState left in the same
    state, finite metrics; an empty scene returns None in both."""
    tsm, jsm = _plane_scenes()
    jseen = []
    core = JS.optimization_step_core

    def record(slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool, keyframe_id, gt, mono, K, bg,
               *a, **k):
        jseen.append((int(keyframe_id), np.asarray(bg).copy()))
        return core(slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool, keyframe_id, gt, mono, K, bg,
                    *a, **k)
    monkeypatch.setattr(JS, "optimization_step_core", record)
    tseen = []
    _record_port(tsm, tseen)
    for _ in range(N_CALLS):
        tm = tsm.optimization_step(is_important=True)
        jm = jsm.optimization_step(is_important=True)
        assert np.isfinite(float(tm["loss"])) and np.isfinite(float(jm["loss"]))
    assert [k for k, _ in tseen] == [k for k, _ in jseen]
    assert len({k for k, _ in tseen}) > 1       # the draw visits several keyframes
    for (_, a), (_, b) in zip(tseen, jseen):
        np.testing.assert_array_equal(a, b)
    assert tsm.last_trained_id == jsm.last_trained_id
    ts, js = tsm._np_rng.get_state(), jsm._np_rng.get_state()
    assert ts[2] == js[2] and (ts[1] == js[1]).all()

    empty_t = SceneModel(W, H, np.eye(3), MapperConfig(**SIZES), device=CPU)
    empty_j = JS.SceneModel(W, H, np.eye(3), JMapperConfig(**SIZES))
    assert empty_t.optimization_step() is None and empty_j.optimization_step() is None


@pytest.mark.parametrize("finetuning", [False, True])
def test_optimization_steps_are_the_loop(finetuning):
    """N calls of optimization_step and one optimization_loop(N) from one
    state: the same keyframes and backgrounds, bitwise the same slab and
    RandomState."""
    a, _ = _plane_scenes(jax_too=False)
    b, _ = _plane_scenes(jax_too=False)
    seen_a, seen_b = [], []
    _record_port(a, seen_a)
    _record_port(b, seen_b)
    for _ in range(N_CALLS):
        a.optimization_step(is_important=False, finetuning=finetuning)
    b.optimization_loop(N_CALLS, is_important=False, finetuning=finetuning)
    assert [k for k, _ in seen_a] == [k for k, _ in seen_b] and len(seen_a) == N_CALLS
    for (_, x), (_, y) in zip(seen_a, seen_b):
        np.testing.assert_array_equal(x, y)
    assert a.last_trained_id == b.last_trained_id
    assert a.n_train_steps == b.n_train_steps == N_CALLS
    for f in dataclasses.fields(a.slab):
        x, y = getattr(a.slab, f.name), getattr(b.slab, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
    sa, sb = a._np_rng.get_state(), b._np_rng.get_state()
    assert sa[2] == sb[2] and (sa[1] == sb[1]).all()


# ---------------------------------------------------------------------------
# the profilers' rows against their JAX counterparts'
# ---------------------------------------------------------------------------

def _label_prefix(node) -> str:
    """The constant text of a str or f-string up to its first placeholder."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.strip()
    if isinstance(node, ast.JoinedStr):
        text = ""
        for part in node.values:
            if not isinstance(part, ast.Constant):
                break
            text += part.value
        return text.strip()
    return ""


def jax_labels(script: str) -> set:
    """Every label the JAX script prints a number under: the first argument
    of each ``timeit(...)`` and ``log(...)`` call, up to its first
    placeholder (empty labels, ``timeit``'s own line, are left out)."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("timeit", "log") and node.args):
            label = _label_prefix(node.args[0])
            if label:
                out.add(label)
    return out


def _rows_ok(rows: dict, keys) -> None:
    for k in keys:
        assert k in rows, k
        v = rows[k]
        assert isinstance(v, (int, float)) and math.isfinite(v) and v >= 0, (k, v)


def _check_mapping(script: str, mapping: dict, rows: dict) -> None:
    """``mapping``: each JAX label -> the port's row keys it stands for
    (empty for progress lines)."""
    assert jax_labels(script) == set(mapping), jax_labels(script) ^ set(mapping)
    for keys in mapping.values():
        _rows_ok(rows, keys)


def test_profile_render_has_every_jax_row():
    rows = profile_render.main(CPU, sizes=(1500, 3000), width=96, height=64, repeats=1)
    assert set(rows) == {1500, 3000}
    mapping = {
        "N =": [],
        "project": ["project"], "sh_to_color": ["sh_to_color"],
        "depth argsort": ["depth argsort"], "gather-reorder x5": ["gather-reorder x5"],
        "build_tile_bins (16N-pair sort)": ["build_tile_bins (16N-pair sort)"],
        # the port's slot gather (api.SlotGather) in place of JAX's scatter
        "pack+scatter+composite": ["pack+slot gather+composite"],
        "FULL rasterization fwd": ["FULL rasterization fwd"],
        "FULL rasterization fwd+bwd": ["FULL rasterization fwd+bwd"],
        "[visible gaussians:": ["visible", "pairs"],
    }
    for size_rows in rows.values():
        _check_mapping("profile_render.py", mapping, size_rows)
        assert 0 < size_rows["visible"] and size_rows["pairs"] >= size_rows["visible"]


def test_profile_refine_has_every_jax_row():
    rows = profile_refine.main(CPU, h=32, w=48, repeats=1)
    _check_mapping("profile_refine.py", {
        "refine_dense full (5 levels)": ["refine_dense full (5 levels)"],
        "_dense_best d=": ["K3 window_argmax d=5 (81 offsets)",
                           "K3 window_argmax d=1 (81 offsets)"],
        # the XLA route's claim pass and loser drain have no counterpart:
        # the port's glue around K3 and the per-level gathers K3 replaces
        "claim+scatter glue (1 level)": ["glue: bf16 casts + 3 x 8-channel planes"],
        "sparse loser pass (chunk=": ["per-level gathers (plain version, d=5)"],
        "iter_proj b=1 (10 it, random init)": ["iter_proj b=1 (10 it, random init)"],
        "iter_proj b=1 (identity init)": ["iter_proj b=1 (identity init)"],
    }, rows)


def test_probe_transfers_has_every_jax_row():
    rows = probe_transfers.main(CPU, size=128, steps=4, h=36, w=64)
    _check_mapping("probe_transfers.py", {
        "compute alone:": ["compute alone"],
        "h2d": ["h2d f32 pageable alone", "h2d f32 pinned alone", "h2d u8 pageable alone",
                "h2d u8 pinned alone"],
        "compute + f32 h2d together:": ["compute + f32 h2d together (default stream, pageable)",
                                        "compute + f32 h2d together (second stream, pinned)"],
        "device u8->slam cast:": ["device u8->slam cast"],
        "d2h of ready array while compute queued:": [
            "d2h of ready array while compute queued (default stream)",
            "d2h of ready array while compute queued (second stream)"],
    }, rows)


def test_profile_stages_has_every_jax_row(monkeypatch):
    """6 frames of the stream at 256x144 with a 128-pixel SLAM stream
    (128x64: 3 keyframes) and a 2^12-row starting slab, patched in where
    the oracle set-up (``bench.oracle_system``) and the script read them;
    each row timed once."""
    from artdeco_tpu_torch import bench

    args, cfg = bench.pipeline_args(), profile_stages.stage_mapper_config()
    args.max_size_slam = 128
    monkeypatch.setattr(bench, "pipeline_args", lambda: args)
    monkeypatch.setattr(profile_stages, "stage_mapper_config",
                        lambda: cfg._replace(initial_capacity=1 << 12))
    rows = profile_stages.main(CPU, n_frames=6, width=256, height=144, repeats=0.125)
    h, w = 64, 128
    _check_mapping("profile_stages.py", {
        "warming: streaming 24 frames (sequential)...": [], "warm done in": [],
        "scalar sync round-trip:": ["scalar sync round-trip"],
        "h2d 3x": [f"h2d 3x{h}x{w} + sync"], "d2h": [f"d2h {h}x{w}x3"],
        "match_asymmetric (cascade b=1, incl oracle glue)": [
            "match_asymmetric (cascade b=1, incl oracle glue)"],
        "track_step (fused LM + gates)": ["track_step (fused LM + gates)"],
        "match_symmetric b=": [f"match_symmetric b={b} ({2 * b} cascades)" for b in (1, 2, 4)],
        "iter_proj b=": [f"iter_proj b={b}" for b in (1, 2, 4, 8)],
        "refine_dense b=": [f"refine_dense b={b}" for b in (1, 2, 4, 8)],
        "full cascade b=": [f"full cascade b={b}" for b in (1, 2, 4, 8)],
        "GN solve (current graph:": ["GN solve"],
        "[gaussians active:": ["gaussians", "slab_capacity"],
        "mapper single iteration": ["mapper single iteration"],
        "mapper 20-iteration burst": ["mapper 20-iteration burst"],
        "render_from_id (full res, fwd only)": ["render_from_id (full res, fwd only)"],
        "densify (add_new_gaussians)": ["densify (add_new_gaussians)"],
    }, rows)
    assert rows["keyframes"] >= 3 and rows["gaussians_after"] > 0
    assert rows["gn_graph"].endswith("directed")


@pytest.mark.parametrize("module", [profile_render, profile_refine, probe_transfers,
                                    profile_stages])
def test_profilers_need_a_card(module):
    """With no CUDA device, each entry point raises rather than run on the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()

