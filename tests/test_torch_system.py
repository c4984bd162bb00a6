"""The port's ``System`` against the JAX package's ``System``, on the CPU.

At ``tests/test_system.py``'s settings (160x120 frames, SLAM 128x96, map
80x60, 16 frames, ``max_size_slam`` 128, the small matching window): the
port's mapper starts from the JAX mapper's initial state and takes its
densification noise from the same key chain (``torch_parity``), as
``test_torch_slice.py`` does.  Tolerances (the measured gaps in brackets):
the same keyframe frames and 0 lost; keyframe poses and the frame
trajectory within the frontend test's 1e-4 [3.3e-7]; ATE RMSE within 1e-4
of JAX's [equal to 6 digits] and under 0.03 m; the Gaussian count within
2 % [equal]; test PSNR within 0.1 dB [0.027], SSIM within 2e-3 [4e-4] and
LPIPS within 1e-4 [9e-6], the mapper being chaotic at the float32 rounding level
(``test_torch_slice.py``).

Also: the loop-closure transforms of poses and Gaussians (rotations near
180 degrees included), one ``finetune_epoch``, ``save``'s files and its
Gaussian PLY columns from the same slab, overlap against sequential
(bit-identical trajectories), the oracle's frame binding over a long
stream, and the entry point ``python -m artdeco_tpu_torch.run_system`` on
a tiny clip.
"""

import os
import gc
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.dataio.args import get_args as jget_args
from artdeco_tpu.mapper import gaussians as JG
from artdeco_tpu.mapper import scene_io as jscene_io
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.models.oracle import OracleRunner as JOracleRunner
from artdeco_tpu.runtime.system import System as JSystem
from artdeco_tpu.runtime.system import _rigid_fn_for
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu_torch.dataio.args import get_args
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper import gaussians as G
from artdeco_tpu_torch.mapper import scene_io
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.scene_model import SceneModel
from artdeco_tpu_torch.mapper.state_io import scene_state_from_numpy
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.runtime.system import System, rigid_transform_poses
from artdeco_tpu_torch.utils.config import load_config
from test_system import _args
from test_torch_backend import register
from torch_parity import CPU, JaxKeyChain, jax_scene_state, n, t, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "config", "base.yaml")
SIZES = dict(capacity=4096, cluster_capacity=1024, voxel_table_size=4096, new_budget=1024,
             keyframe_capacity=64, sh_degree=1, local_feat_dim=8, global_feat_dim=8,
             pyr_levels=1, gs_add_ratio=1.0, init_proba_scaler=4.0)


def _config(load):
    cfg = load(CFG)
    cfg["matching"].update(radius=1, dilation_max=1, dist_thresh=0.05)
    return cfg


def jax_system(n_frames=16):
    args = _args()
    ds = JSyntheticDataset(args, n_frames=n_frames, width=160, height=120)
    cfg = _config(jload_config)
    runner = JOracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"])
    register(runner, ds)
    return JSystem(args, cfg, ds, runner, mapper_cfg=JMapperConfig(**SIZES))


def port_system(n_frames=16, jsys=None):
    """The port's System at test_system.py's settings; with ``jsys`` its
    mapper starts from that JAX System's initial mapper state and noise."""
    args = _args()
    ds = SyntheticDataset(args, n_frames=n_frames, width=160, height=120)
    cfg = _config(load_config)
    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=CPU)
    register(runner, ds)
    sys_ = System(args, cfg, ds, runner, mapper_cfg=MapperConfig(**SIZES), device=CPU,
                  noise=JaxKeyChain(0) if jsys is not None else None)
    if jsys is not None:
        sys_.scene_model.load_state(scene_state_from_numpy(jax_scene_state(jsys.scene_model),
                                                           CPU))
    return sys_


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    jsys = jax_system()
    tsys = port_system(jsys=jsys)
    jsys.run(progress=False)
    tsys.run(progress=False)
    jout, tout = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "port"))
    jmeta, tmeta = jsys.save(jout), tsys.save(tout)
    return jsys, tsys, jmeta, tmeta, jout, tout


def test_system_matches_jax(ran):
    jsys, tsys, jmeta, tmeta, _, _ = ran
    assert tsys.n_frames == jsys.n_frames == 16
    assert tsys.frontend.lost_number == jsys.frontend.lost_number == 0
    n_kf = len(tsys.keyframes)
    assert n_kf == len(jsys.keyframes) >= 1
    np.testing.assert_array_equal(tsys.keyframes.dataset_idx[:n_kf],
                                  jsys.keyframes.dataset_idx[:n_kf])
    np.testing.assert_allclose(tsys.keyframes.T_WC[:n_kf], jsys.keyframes.T_WC[:n_kf],
                               atol=1e-4)
    est, jest = tsys.frontend.estimated_trajectory(), jsys.frontend.estimated_trajectory()
    assert est.shape == jest.shape and len(est) > 4
    np.testing.assert_allclose(est, jest, atol=1e-4)
    ate, jate = tmeta["trajectory"]["APE"]["rmse"], jmeta["trajectory"]["APE"]["rmse"]
    assert abs(ate - jate) <= 1e-4 and ate < 0.03, (ate, jate)
    assert tsys.mapper_index == jsys.mapper_index >= 1
    assert abs(tmeta["n_gaussians"] - jmeta["n_gaussians"]) <= 0.02 * jmeta["n_gaussians"]
    assert tmeta["n_gaussians"] > 100
    tm, jm = tmeta["metrics"], jmeta["metrics"]
    assert tm["n_test_frames"] == jm["n_test_frames"] >= 1
    assert abs(tm["PSNR"] - jm["PSNR"]) < 0.1 and np.isfinite(tm["PSNR"])
    assert abs(tm["SSIM"] - jm["SSIM"]) < 2e-3
    assert abs(tm["LPIPS"] - jm["LPIPS"]) < 1e-4 and np.isfinite(tm["LPIPS"])


def test_save_outputs_match_jax(ran):
    """The files ``tests/test_system.py`` checks, and every file the JAX
    package's save writes; the Gaussian PLY of the same slab column for
    column."""
    jsys, tsys, _, _, jout, tout = ran
    for rel in ("metadata.json", "run_metadata.json", "slam/frames.txt", "slam/keyframes.txt",
                "slam/lost_percentage.txt", "slam/config.json", "point_clouds/gs.ply",
                "point_clouds/xyz_rgb.ply", "colmap/cameras.bin", "colmap/images.bin",
                "colmap/points3D.bin", "colmap/points3D.ply", "onthefly.txt", "onthefly.ply"):
        assert os.path.isfile(os.path.join(tout, rel)), rel
        assert os.path.isfile(os.path.join(jout, rel)), rel
    assert os.listdir(os.path.join(tout, "test_images"))
    # the same slab through both writers
    sm = SceneModel(jsys.scene_model.width, jsys.scene_model.height, jsys.dataset.K_map,
                    MapperConfig(**SIZES), device=CPU)
    sm.load_state(scene_state_from_numpy(jax_scene_state(jsys.scene_model), CPU))
    pj, pt = (os.path.join(tout, f"same_{k}.ply") for k in ("jax", "port"))
    nj = jscene_io.save_gaussian_ply(pj, jsys.scene_model)
    nt = scene_io.save_gaussian_ply(pt, sm)
    assert nj == nt > 100
    fj, ft = jscene_io.read_gaussian_ply(pj), scene_io.read_gaussian_ply(pt)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-6, atol=1e-6, err_msg=k)
    # the port's reader reads the JAX package's file as the JAX reader does
    for k, v in scene_io.read_gaussian_ply(pj).items():
        np.testing.assert_array_equal(v, fj[k])
    pj, pt = (os.path.join(tout, f"xyz_{k}.ply") for k in ("jax", "port"))
    jscene_io.save_xyz_rgb_ply(pj, jsys.scene_model)
    scene_io.save_xyz_rgb_ply(pt, sm)
    assert open(pj, "rb").read() == open(pt, "rb").read()


def _random_c2w(rng, k, near_pi):
    out = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    for i in range(k):
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        ang = np.pi - 1e-3 * rng.rand() if near_pi[i] else rng.uniform(-1, 1)
        Kx = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                         [-axis[1], axis[0], 0]])
        out[i, :3, :3] = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * Kx @ Kx
        out[i, :3, 3] = rng.randn(3)
    return out


def test_rigid_transforms_match_jax():
    """``gaussians.rigid_transform`` and the loop-closure pose recompute,
    with half the keyframes' corrections within 1e-3 rad of 180 degrees:
    positions within 1e-5, quaternions within 1e-5 (up to sign)."""
    rng = np.random.RandomState(0)
    cap, n_g = 8, 500
    slab = G.create_slab(n_g, 1, 8, 1e-4, CPU)
    q = rng.randn(n_g, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    fields = dict(xyz=rng.randn(n_g, 3).astype(np.float32), rotation=q,
                  kf_id=rng.randint(0, cap, n_g).astype(np.int32))
    import dataclasses

    tslab = dataclasses.replace(slab, **{k: t(v) for k, v in fields.items()})
    jslab = dataclasses.replace(JG.create_slab(n_g, 1, 8, 1e-4),
                                **{k: jnp.asarray(v) for k, v in fields.items()})
    old = _random_c2w(rng, cap, [False] * cap)
    new = _random_c2w(rng, cap, [i % 2 == 0 for i in range(cap)])
    tout = G.rigid_transform(tslab, t(old), t(new))
    jout = JG.rigid_transform(jslab, jnp.asarray(old), jnp.asarray(new))
    np.testing.assert_allclose(n(tout.xyz), np.asarray(jout.xyz), atol=1e-5)
    a, b = n(tout.rotation), np.asarray(jout.rotation)
    sign = np.sign(np.sum(a * b, axis=1, keepdims=True))
    np.testing.assert_allclose(a * sign, b, atol=1e-5)

    # the pose recompute: SLAM poses (some near 180 degrees), relative
    # poses for mapper frames, at keyframe capacity with a mask
    from artdeco_tpu.geometry import lie as jlie
    from artdeco_tpu.mapper import keyframe as JKF
    from artdeco_tpu_torch.mapper import keyframe as KF

    xi = rng.randn(cap, 7).astype(np.float32) * 0.3
    xi[::2, 3:6] *= (np.pi - 1e-3) / np.linalg.norm(xi[::2, 3:6], axis=1, keepdims=True)
    slam_T = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    TCkC = np.asarray(jlie.sim3_exp(jnp.asarray(rng.randn(cap, 7).astype(np.float32) * 0.1)))
    is_kf = np.arange(cap) % 3 == 0
    mask = np.arange(cap) < 6
    pool, jpool = KF.create_pool(cap, CPU), JKF.create_pool(cap)
    Rt0 = np.linalg.inv(old)
    for i in range(cap):
        KF.set_keyframe(pool, i, t(Rt0[i]), torch.eye(3, 4), 0.0, 0.0, 0.0, False)
        jpool = JKF.set_keyframe(jpool, i, jnp.asarray(Rt0[i]), jnp.eye(3, 4), 0.0, 0.0, 0.0,
                                 False)
    got = rigid_transform_poses(pool, t(slam_T), t(TCkC), t(is_kf), t(mask))
    want = _rigid_fn_for(cap)(jpool, jnp.asarray(slam_T), jnp.asarray(TCkC),
                              jnp.asarray(is_kf), jnp.asarray(mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(n(KF.get_all_c2w(pool)), np.asarray(JKF.get_all_c2w(jpool)),
                               atol=1e-5)


def test_finetune_epoch_matches_jax(ran):
    """One finetune epoch from the same scene, keyframes and host RNG state:
    the slab within the slice test's bounds (all but 1 % of each field
    within 2e-5 + 1e-4 relative, every element within 1e-3)."""
    from test_torch_slice import _slab_close

    jsys, tsys, _, _, _, _ = ran
    jsm, tsm = jsys.scene_model, tsys.scene_model
    tsm.load_state(scene_state_from_numpy(jax_scene_state(jsm), CPU))
    tsm._np_rng.set_state(jsm._np_rng.get_state())
    tsm.last_trained_id = jsm.last_trained_id
    jsm.finetune_epoch()
    tsm.finetune_epoch()
    assert tsm.last_trained_id == jsm.last_trained_id
    _slab_close(tsm.slab, jsm.slab, max_share=0.01, cap=1e-3)
    np.testing.assert_allclose(n(tsm.mlp_lr), np.asarray(jsm.mlp_lr), rtol=1e-6)


def test_overlap_reproduces_sequential_trajectory():
    """The worker thread writes nothing the tracker reads: overlapped and
    sequential runs give bit-identical trajectories on the CPU."""
    outs = []
    for overlap in (False, True):
        sys_ = port_system(n_frames=14)
        sys_.run(progress=False, overlap=overlap)
        outs.append((sys_.frontend.estimated_trajectory(), sys_.frontend.keyframe_trajectory(),
                     sys_.mapper_index, sys_.scene_model.n_active_gaussians))
    (est_s, kf_s, n_s, _), (est_o, kf_o, n_o, gs_o) = outs
    assert est_s.shape == est_o.shape and len(est_s) > 4
    np.testing.assert_array_equal(est_s, est_o)
    np.testing.assert_array_equal(kf_s, kf_o)
    assert n_o == n_s and gs_o > 0


def test_args_match_jax():
    """The port's get_args is the JAX package's plus --device."""
    argv = ["-s", "synthetic://", "-d", "synthetic", "--oracle", "--test_hold", "4"]
    a, b = vars(get_args(argv)), vars(jget_args(argv))
    assert a.pop("device") is None
    assert a == b


def test_entry_point_runs_on_the_cpu(tmp_path):
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "artdeco_tpu_torch.run_system", "-s", "synthetic://",
           "-d", "synthetic", "--oracle", "--device", "cpu", "--max_size_slam", "64",
           "--downsampling", "4", "--test_hold", "4", "--num_key_iterations", "2",
           "--sh_degree", "1", "--local_feat_dim", "8", "--global_feat_dim", "8",
           "--pyr_levels", "1", "--retrieval_checkpoint_path", "", "-m", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "done: 30 frames" in res.stdout, res.stdout
    for rel in ("run_metadata.json", "slam/frames.txt", "point_clouds/gs.ply"):
        assert (out / rel).is_file(), rel


def test_oracle_binding_lives_with_its_tensor():
    """A bound image finds its frame by identity for as long as the tensor
    lives, however many frames were bound after it (the mapper worker uses
    a mapper frame's image well after later uploads), and its entry goes
    with the tensor."""
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=64), n_frames=100,
                          width=64, height=48)
    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, load_config(CFG)["matching"],
                          device=CPU)
    register(runner, ds)
    imgs = []
    for i in range(len(ds)):
        host = ds.transform.to_slam(ds[i][0])
        imgs.append(torch.from_numpy(host.copy()))
        runner.bind(imgs[-1], host)
    assert all(runner._by_id[id(x)][0]() is x for x in imgs)
    assert [runner._by_id[id(x)][1] for x in imgs] == list(range(len(ds)))
    key = id(imgs[5])
    del imgs[5]
    gc.collect()
    assert key not in runner._by_id
    assert len(runner._by_id) == len(ds) - 1
