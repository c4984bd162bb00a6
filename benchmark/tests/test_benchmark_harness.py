"""CPU tests of the benchmark's harness: files found by name, the contract's
shape of BENCHMARK.json, the generator, the work counts, the import guard.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, work  # noqa: E402
from benchmark.reference import mast3r_plain  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from benchmark.traffic import stream  # noqa: E402

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_finds_every_file_by_name():
    for cfg in SPEC["configs"]:
        c = harness.load_config(cfg["name"])
        assert c["name"] == cfg["name"]
        assert (REPO / cfg["file"]).is_file()
        assert callable(harness.load_driver(c["entry"]))
    for cell in SPEC["workloads"]:
        assert harness.load_traffic(cell["traffic"])["name"] == cell["traffic"]
        lim = harness.load_limits(cell["name"])
        assert lim["cell"] == cell["name"] and lim["limits"]
    for m in SPEC["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"]), m["name"]
        assert callable(mod.read)


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"frames_per_s", "frame_ms_p50", "frame_ms_p90", "setup_s"}
    cells = {c["name"]: c for c in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers: dict = {}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        layers.setdefault(m["layer"], []).append(m["name"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in cells.values():
        assert c["chips"] == 1 and len(c["why"]) <= 200
        reports = [m for m in SPEC["per_layer"] if c["name"] in m["workloads"]]
        assert reports, c["name"]
        # setup_s and another end-to-end metric; each per-layer metric moves
        # one that the cell reports
        e2e_here = {m["name"] for m in harness.metrics_of(SPEC, c["name"], "end_to_end")}
        assert "setup_s" in e2e_here and len(e2e_here) >= 2, c["name"]
        for m in reports:
            assert m["moves"] in e2e_here, (m["name"], c["name"])
    for cfg in SPEC["configs"]:
        assert cfg["file"].startswith("benchmark/")
        assert any(c["config"] == cfg["name"] for c in cells.values())
        # every key listed as changed is a key of the file, and none a width
        file_cfg = harness.load_config(cfg["name"])
        assert file_cfg["reduced"] == cfg["reduced"]
        for key in cfg["reduced"]:
            assert NAME.match(key) and _has_key(file_cfg, key), key
            assert not re.search(r"(_dim|_rank|hidden|width|heads|ratio)", key), key


def _has_key(tree, key) -> bool:
    if isinstance(tree, dict):
        return key in tree or any(_has_key(v, key) for v in tree.values())
    return False


def test_generator_is_deterministic_per_seed_and_the_work_is_not():
    mix = harness.load_traffic("track")
    mix.update(width=64, height=48)
    a = stream.trajectory(mix, 2 ** 31 + 5, 30)
    b = stream.trajectory(mix, 2 ** 31 + 5, 30)
    c = stream.trajectory(mix, 2 ** 31 + 6, 30)
    assert np.array_equal(a, b)
    # the seed picks only mirror images: the direction along the heading
    # and the roll's sign
    dirs = {np.sign(stream.trajectory(mix, s, 2)[1, 0]) for s in range(16)}
    rolls = {np.sign(stream.trajectory(mix, s, 2)[1, 5]) for s in range(16)}
    assert dirs == {-1.0, 1.0} and rolls == {-1.0, 1.0}
    for p in (a, c):        # the same step and roll amplitude for every seed
        steps = np.linalg.norm(np.diff(p[:, :3], axis=0), axis=1)
        np.testing.assert_allclose(steps, mix["step_m"], rtol=1e-9)
        assert np.all(np.abs(2 * np.arcsin(p[:, 5])) <= mix["roll_amp_rad"] + 1e-12)
    fa = stream.frames(mix, 2 ** 31 + 5, a[:4], "cpu")
    fb = stream.frames(mix, 2 ** 31 + 5, b[:4], "cpu", batch=3)
    fc = stream.frames(mix, 2 ** 31 + 6, c[:4], "cpu")
    assert fa.dtype == np.uint8 and fa.shape == (4, 48, 64, 3)
    assert np.array_equal(fa, fb) and not np.array_equal(fa, fc)
    assert fa.std() > 20         # a texture, not a flat field


@pytest.mark.parametrize("name", ["fwd", "dense"])
def test_oracle_paths_start_where_bfloat16_rounds_coarsely(name):
    """The oracle mixes' paths start 4 m out and move away, so the bfloat16
    control rounds every position of any window to 31.25 mm or coarser,
    however far the window reaches."""
    mix = harness.load_traffic(name)
    n = mix["warmup_frames"] + mix["window_frames_max"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 5):
        d = np.linalg.norm(stream.trajectory(mix, seed, n)[:, :2], axis=1)
        assert d[0] == mix["start_m"] >= 4.0 and np.all(np.diff(d) > 0)


def test_frames_follow_the_plane_geometry():
    """Each pixel shows the texture at the world point its ray meets on the
    plane, with the poses read as the check reads them (camera to world,
    [t, q_xyzw]), roll included."""
    from benchmark.reference import poses as P

    mix = harness.load_traffic("fwd")
    mix.update(width=160, height=96)
    poses = stream.trajectory(mix, 2 ** 31 + 9, 40)[::13]
    frames = stream.frames(mix, 2 ** 31 + 9, poses, "cpu").astype(float)
    tex = stream.texture_params(mix, 2 ** 31 + 9)
    W, H, z = 160, 96, mix["plane_z"]
    f = stream.FOCAL_FRAC * W
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    rays = np.stack([(u - W / 2) / f, (v - H / 2) / f, np.ones_like(u, float)], -1)
    amp = mix["texture_contrast"] / len(mix["texture_periods_m"])
    for pose, img in zip(poses, frames):
        d = rays @ P.quat_to_R(pose[3:7]).T
        X = pose[:3] + d * ((z - pose[2]) / d[..., 2:3])
        arg = (2 * np.pi * (X[..., 0, None, None] * np.cos(tex["angle"])
                            + X[..., 1, None, None] * np.sin(tex["angle"]))
               / np.asarray(mix["texture_periods_m"]) + tex["phase"])
        want = np.clip(0.5 + amp * np.sin(arg).sum(-1), 0, 1) * 255
        assert np.abs(img - want).max() < 1.5


@pytest.mark.parametrize("hw", [(64, 96), (48, 80)])
def test_mast3r_flops_match_flop_counter_on_the_reference(hw):
    from torch.utils.flop_counter import FlopCounterMode

    c = mast3r_plain.widths_from(tiny.TINY_MODEL)
    sd = mast3r_plain.draw_state_dict(c, 3, "cpu")
    model = mast3r_plain.build(c, sd, "cpu")
    img = torch.rand(1, 3, *hw) * 2 - 1
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            f1, p1 = model.encode(img)
        enc = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            model.pair(f1, p1, f1, p1, hw)
        dec = fc.get_total_flops()
    assert work.mast3r_flops(c, *hw) == (enc, dec)


def test_mast3r_flops_at_the_published_widths():
    """523.2 GFLOP an encode at 512x384 (PR 12's FlopCounterMode count of the
    program's model read 523.0)."""
    cfg = harness.load_config("mast3r-vitl-512")
    enc, dec = work.mast3r_flops(mast3r_plain.widths_from(cfg["model"]), 384, 512)
    assert 522e9 < enc < 524e9 and 0.9e12 < dec < 1.1e12


def test_k3_bytes_from_shapes():
    h, w, c = 288, 512, 24
    n = h * w
    assert work.k3_bytes(h, w, c) == 2 * n * c + 2 * n * c + 21 * n
    assert work.k3_bytes(288, 512, 24) == 17_252_352


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "artdeco_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "artdeco_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "artdeco_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["artdeco_tpu", "jax"]


def test_benchmark_sources_import_nothing_forbidden():
    bad = []
    for path in (REPO / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in harness.FORBIDDEN_MODULES]
    assert not bad
    for path in (REPO / "benchmark" / "reference").rglob("*.py"):
        assert "artdeco_tpu_torch" not in path.read_text(), path


def test_percentile_matches_numpy():
    v = list(np.random.default_rng(0).exponential(size=97))
    for q in (50, 90):
        assert math.isclose(harness.percentile(v, q), float(np.percentile(v, q)))


def test_model_step_readers_read_the_head_before_the_slice():
    lat = [0.1] * 10 + [0.3] * 30
    win = harness.Window(seconds=5.0, latencies=lat, attempted=40, failed=0)
    run = harness.Run({}, {"model": {}}, {}, win, {}, {"open": {"frames": 8},
                      "slice_open": {"frames": 18}}, None, {"head_s": 1.0})
    mod = harness.load_metric("step_ms_p50")
    rate = harness.load_metric("step_frames_per_s")
    assert math.isclose(mod.read(run), 100.0)
    assert math.isclose(rate.read(run), 10.0)
    run.extra = {"head_s": None}
    assert math.isclose(mod.read(run), 300.0)
    assert math.isclose(rate.read(run), 8.0)
    run.config = {}
    assert mod.read(run) is None and rate.read(run) is None
