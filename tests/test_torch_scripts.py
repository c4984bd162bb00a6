"""The port's run-inspection scripts (``artdeco_tpu_torch/scripts/``)
against the JAX package's ``scripts/`` on the same temporary inputs.

The JAX scripts run in one subprocess on the CPU (each as ``__main__``
with its own argv); the port's in this process through ``main(argv)`` on
the CPU.  Their PLY files are byte for byte the same; their ATE, RPE and
motion statistics within 1e-6; ``visualize_gs``'s PNG frames equal but for
one level where the float frames straddle a level (``LEVEL_SHARE`` of the
values at most), and its MP4 holds the frames as JPEG samples where the
JAX script's holds ``mp4v``.  ``test_sim3`` draws its poses from a seeded
``torch.Generator``, not from JAX's PRNG: both must print OK with an error
under 1e-4.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from artdeco_tpu_torch.dataio.image_io import read_png
from artdeco_tpu_torch.dataio.jpeg import jpeg_size
from artdeco_tpu_torch.dataio.tum_io import save_tum_trajectory
from artdeco_tpu_torch.dataio.video import read_mp4_samples
from artdeco_tpu_torch.mapper.scene_io import gaussian_ply_fields, write_png, write_ply
from artdeco_tpu_torch.scripts import (compare_pose, scannetpp_check, test_sim3, traj,
                                       tum_pose_to_ply, visualize_gs, visualize_pointmap)
from torch_parity import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL_SHARE = 1e-3
N_POSES = 40

# the JAX scripts, each run as __main__ with its argv, in one process
DRIVER = r"""
import contextlib, io, json, os, runpy, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
out = {{}}
for name, argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    sys.argv = [name] + argv
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join({repo!r}, "scripts", name + ".py"), run_name="__main__")
    out[name + " " + " ".join(argv)] = buf.getvalue()
print("@@" + json.dumps(out))
"""


def _quat(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded inputs: two TUM trajectories (b is a noisy, 5 ms-shifted a), a
    pointmap dump, a saved run (a Gaussian PLY and its metadata), a
    scene_metadata.npz tree and a TUM sequence with ground truth."""
    root = tmp_path_factory.mktemp("scripts")
    rng = np.random.RandomState(0)
    ts = 100.0 + np.arange(N_POSES) / 30.0
    pos = np.cumsum(0.02 * rng.randn(N_POSES, 3), axis=0)
    q = _quat(rng, N_POSES)
    save_tum_trajectory(str(root / "a.txt"), ts, np.concatenate([pos, q], 1))
    qb = q + 0.01 * rng.randn(N_POSES, 4)
    save_tum_trajectory(str(root / "b.txt"), ts + 0.005, np.concatenate(
        [1.5 * pos + 0.003 * rng.randn(N_POSES, 3), qb / np.linalg.norm(qb, axis=1,
                                                                         keepdims=True)], 1))
    np.save(root / "pts.npy", (3.0 * rng.randn(6, 500, 3)).astype(np.float32))

    run = root / "run"
    os.makedirs(run / "point_clouds")
    m = 400
    z = 1.5 + 2.0 * rng.rand(m)
    cols = ([(2 * rng.rand(m) - 1) * 0.6 * z, (2 * rng.rand(m) - 1) * 0.45 * z, z]
            + [np.zeros(m)] * 3 + list(rng.randn(3, m)) + list(0.2 * rng.randn(9, m))
            + [rng.randn(m)] + list(np.log(0.02 + 0.05 * rng.rand(3, m)))
            + list(rng.randn(4, m)))
    write_ply(str(run / "point_clouds" / "gs.ply"), gaussian_ply_fields(1),
              [np.asarray(c, np.float32) for c in cols])
    with open(run / "metadata.json", "w") as f:
        json.dump({"config": {"width": 64, "height": 48, "sh_degree": 1, "f": 60.0}}, f)

    trees = root / "trees"
    for k, sub in enumerate(("scene_a", "scene_b")):
        os.makedirs(trees / sub)
        T = np.tile(np.eye(4), (12, 1, 1))
        for i in range(12):
            c, s = np.cos(0.02 * i * (k + 1)), np.sin(0.02 * i * (k + 1))
            T[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            T[i, :3, 3] = 0.01 * i * np.array([1, 2, 3]) + 0.001 * rng.randn(3)
        names = np.array([f"{i:03d}.jpg" for i in rng.permutation(12)])
        np.savez(trees / sub / "scene_metadata.npz", trajectories=T, images=names)

    tum = root / "tum"
    os.makedirs(tum / "rgb")
    with open(tum / "rgb.txt", "w") as f:
        for i in range(12):
            rel = f"rgb/{ts[i]:.6f}.png"
            write_png(str(tum / rel), rng.randint(0, 256, (48, 64, 3), np.uint8))
            f.write(f"{ts[i]:.6f} {rel}\n")
    save_tum_trajectory(str(tum / "groundtruth.txt"), ts[:12],
                        np.concatenate([pos[:12], q[:12]], 1))
    return root


def _port(module, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(inputs):
    """Each script's (JAX stdout, port stdout) and the directories they wrote."""
    r = str(inputs)
    jax_dir, port_dir = inputs / "jax", inputs / "port"
    os.makedirs(jax_dir)
    os.makedirs(port_dir)

    def calls(d):
        return [
            ("traj", [f"{r}/a.txt", "-o", f"{d}/traj.ply"]),
            ("tum_pose_to_ply", [f"{r}/a.txt", "-o", f"{d}/poses.ply", "--size", "0.2"]),
            ("visualize_pointmap", [f"{r}/pts.npy", "--window", "1", "4", "--stride", "2",
                                    "--max_dist", "6", "--out", f"{d}/win.ply"]),
            ("compare_pose", [f"{r}/a.txt", f"{r}/b.txt", "--max_dt", "0.01"]),
            ("scannetpp_check", [f"{r}/trees", "--skip_tail", "2", "-o", f"{d}/trees.json"]),
            ("scannetpp_check", ["-s", f"{r}/tum", "-d", "tum", "--downsampling", "1",
                                 "--max_size_slam", "64", "-o", f"{d}/tum.json"]),
            ("visualize_gs", [f"{r}/run", "--frames", "4", "--mode", "splat", "--width", "64",
                              "--height", "48", "--out", f"{d}/turntable"]),
            ("test_sim3", []),
        ]

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", DRIVER.format(repo=REPO),
                          json.dumps(calls(jax_dir))], cwd=str(inputs), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_out = json.loads(res.stdout.split("@@", 1)[1])
    modules = dict(traj=traj, tum_pose_to_ply=tum_pose_to_ply,
                   visualize_pointmap=visualize_pointmap, compare_pose=compare_pose,
                   scannetpp_check=scannetpp_check, visualize_gs=visualize_gs,
                   test_sim3=test_sim3)
    out = {}
    for (name, jargv), (_, argv) in zip(calls(jax_dir), calls(port_dir)):
        if name in ("visualize_gs", "test_sim3"):
            argv = argv + ["--device", "cpu"]
        key = f"{name} {argv[0] if argv else ''}".strip()
        out[key] = (jax_out[name + " " + " ".join(jargv)], _port(modules[name], argv))
    return out, jax_dir, port_dir


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


@pytest.mark.parametrize("name,ply", [("traj", "traj.ply"), ("tum_pose_to_ply", "poses.ply"),
                                      ("visualize_pointmap", "win.ply")])
def test_ply_scripts(runs, name, ply):
    out, jax_dir, port_dir = runs
    (jtxt, txt), = [v for k, v in out.items() if k.startswith(name)]
    _same_file(jax_dir / ply, port_dir / ply)
    assert txt.replace(str(port_dir), "D") == jtxt.replace(str(jax_dir), "D")


def _numbers(txt: str) -> dict:
    """'label: {dict}' lines -> {label: dict}; other lines as they are."""
    out = {}
    for line in txt.strip().splitlines():
        label, _, rest = line.partition(": ")
        out[label] = ast.literal_eval(rest) if rest.startswith("{") else rest
    return out


def _close(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _close(a[k], b[k], f"{what}.{k}")
    else:
        assert abs(a - b) <= 1e-6, (what, a, b)


def test_compare_pose(runs):
    (jtxt, txt), = [v for k, v in runs[0].items() if k.startswith("compare_pose")]
    got, want = _numbers(txt), _numbers(jtxt)
    assert got["associated poses"] == want["associated poses"] == str(N_POSES)
    _close(got["APE"], want["APE"], "APE")
    _close(got["RPE"], want["RPE"], "RPE")


@pytest.mark.parametrize("which", ["trees", "tum"])
def test_scannetpp_check(runs, which):
    _, jax_dir, port_dir = runs
    with open(jax_dir / f"{which}.json") as f:
        want = json.load(f)
    with open(port_dir / f"{which}.json") as f:
        got = json.load(f)
    _close(got, want, which)
    assert all(v["max_angle"] > 0 for v in got.values())


def test_visualize_gs(runs):
    out, jax_dir, port_dir = runs
    (jtxt, txt), = [v for k, v in out.items() if k.startswith("visualize_gs")]
    assert txt.replace(str(port_dir), "D") == jtxt.replace(str(jax_dir), "D")
    for i in range(4):
        got = read_png(str(port_dir / "turntable" / f"splat_{i:04d}.png"))
        want = cv2.imread(str(jax_dir / "turntable" / f"splat_{i:04d}.png"))[..., ::-1]
        d = np.abs(got.astype(int) - want)
        assert got.shape == (48, 64, 3) and d.max() <= 1 and np.mean(d > 0) <= LEVEL_SHARE
        assert got.max() > 30
    mp4 = read_mp4_samples(str(port_dir / "turntable" / "turntable_splat.mp4"))
    assert len(mp4["samples"]) == 4 and mp4["fps"] == 30.0
    assert all(jpeg_size(s) == (64, 48) for s in mp4["samples"])
    assert os.path.isfile(jax_dir / "turntable" / "turntable_splat.mp4")


def test_sim3_script(runs):
    (jtxt, txt), = [v for k, v in runs[0].items() if k.startswith("test_sim3")]
    for t in (jtxt, txt):
        lines = t.strip().splitlines()
        assert lines[-1] == "OK"
        assert float(lines[0].split(": ")[1]) < 1e-4
