"""The port's multi-device path (``artdeco_tpu_torch/parallel``, the mesh
hooks of the mapper, the GN and ``System``) against the JAX package's, on
the CPU.

The JAX side runs on 4 of the 8 virtual CPU devices that ``conftest.py``
forces; the port on a mesh of 4 slots on the CPU (``Mesh([cpu] * 4)``,
``make_mesh(4, cpu)``), one controller driving every slot.  Tolerances:
the strip renders within 2e-5 of the JAX ones and of the port's own
single-device render (``tests/test_parallel.py``'s); the sharded
``render_from_id`` within 3e-5 (render) and 1e-3 (inverse depth) of the
single-device one, visibility equal; one dp step as
``test_torch_mapper.test_train_iter_matches_jax`` holds one step (loss
rtol 1e-5, parameters and pool rows atol 2e-5 / rtol 1e-4, gradients,
read from the first Adam moment, within 1e-4 of each group's largest
entry, ``mlp_lr`` exact); the sharded GN's poses within 1e-4 in the Sim(3)
log; the 4-slot ``System`` at ``tests/test_system.py::
test_system_multichip_dp``'s settings with ``test_torch_system.py``'s pose
tolerances.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.mapper import keyframe as JKF
from artdeco_tpu.mapper import scene_model as JS
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.models.oracle import OracleRunner as JOracleRunner
from artdeco_tpu.parallel import dp as jdp
from artdeco_tpu.parallel import splats as jsplats
from artdeco_tpu.runtime.system import System as JSystem
from artdeco_tpu.runtime.system import _se3_w2c_matrix_np
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu.vslam import global_opt as jgo
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper import gaussians as TG
from artdeco_tpu_torch.mapper import scene_model as TS
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.state_io import scene_state_from_numpy
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.ops.splat import api as tapi
from artdeco_tpu_torch.parallel import dp as tdp
from artdeco_tpu_torch.parallel import splats as tsplats
from artdeco_tpu_torch.parallel.mesh import Mesh, make_mesh
from artdeco_tpu_torch.runtime.system import System, exact_mapper_messages
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu_torch.vslam import global_opt as go
from test_global_opt import H as GH, K as GK, W as GW, _pose_err
from test_system import _args
from test_torch_backend import register
from test_torch_global_opt import _recover_problem
from test_torch_splat import _close_rel
from torch_parity import CPU, JaxKeyChain, jax_scene_state, n, t, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS = 4


def _jmesh(axis):
    if len(jax.devices()) < N_SLOTS:
        pytest.skip("needs the virtual CPU devices of conftest.py")
    return JMesh(np.array(jax.devices()[:N_SLOTS]), (axis,))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh(monkeypatch):
    mesh = make_mesh(N_SLOTS, "cpu")
    assert mesh.size == mesh.shape["dp"] == N_SLOTS
    assert mesh.devices == (CPU,) * N_SLOTS and mesh.home == CPU
    x = torch.arange(3.0)
    assert mesh.replicate(x, 0) is x
    r = mesh.replicate(x, 1)
    assert r is not x and r.data_ptr() != x.data_ptr() and torch.equal(r, x)
    xs = [torch.tensor([1.0, -2.0]), torch.tensor([3.0, 5.0]), torch.tensor([0.5, 0.5]),
          torch.tensor([-1.0, 1.0])]
    assert torch.equal(mesh.psum(xs), ((xs[0] + xs[1]) + xs[2]) + xs[3])
    assert torch.equal(mesh.pmean(xs), mesh.psum(xs) / 4)
    assert torch.equal(mesh.pmax(xs), torch.tensor([3.0, 5.0]))
    with pytest.raises(ValueError):
        mesh.pmean(xs[:3])
    # CUDA: the first n cards, and the JAX package's error with fewer
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--n_devices 4 but only 2 devices"):
        make_mesh(4, "cuda")
    assert make_mesh(2, "cuda").devices == (torch.device("cuda", 0), torch.device("cuda", 1))


# ---------------------------------------------------------------------------
# row-strip sharded renders
# ---------------------------------------------------------------------------

def test_row_sharded_render_matches_jax_and_single_device():
    """tests/test_parallel.py's scene at 64x128 in 4 strips of 32 rows."""
    rng = np.random.default_rng(0)
    num = 120
    means = (rng.normal(size=(num, 3)) * [0.8, 0.6, 0.3] + [0.0, 0.0, 3.0]).astype(np.float32)
    quats = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (num, 1))
    scales = np.full((num, 3), 0.15, np.float32)
    opac = np.full((num,), 0.8, np.float32)
    colors = rng.uniform(size=(num, 1, 3)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    W, H = 64, 128
    K = np.asarray([[60.0, 0, 32.0], [0, 60.0, 64.0], [0, 0, 1.0]], np.float32)
    valid = np.ones(num, bool)
    args = (means, quats, scales, opac, colors, view, K, valid)

    jfn = jsplats.make_row_sharded_render(_jmesh("sp"), W, H, sh_degree=0, eps2d=0.3)
    j_render, j_alpha = jfn(*(jnp.asarray(a) for a in args))
    fn = tsplats.make_row_sharded_render(Mesh([CPU] * N_SLOTS, "sp"), W, H, sh_degree=0,
                                         eps2d=0.3)
    render, alpha = fn(*(t(a) for a in args))
    ref_render, ref_alpha, _ = tapi.rasterization(*(t(a) for a in args[:7]), W, H,
                                                  sh_degree=0, eps2d=0.3, valid_mask=t(valid))
    assert render.shape == (H, W, 4) and alpha.shape == (H, W, 1)
    for a, b in ((render, ref_render), (alpha, ref_alpha), (render, j_render),
                 (alpha, j_alpha)):
        np.testing.assert_allclose(n(a), n(b), atol=2e-5)
    assert float(alpha.max()) > 0.5
    with pytest.raises(ValueError, match="multiple of 16"):
        tsplats.make_row_sharded_render(Mesh([CPU] * 3, "sp"), W, H, sh_degree=0)


def _core_scene():
    """tests/test_parallel.py's render_core scene: one 64x128 keyframe of a
    textured plane, densified by the JAX mapper, and the same state in the
    port's SceneModel."""
    W, H, F = 64, 128, 70.0
    K = [[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]]
    sizes = dict(capacity=2048, cluster_capacity=512, voxel_table_size=4096,
                 new_budget=512, keyframe_capacity=64, sh_degree=1, local_feat_dim=8,
                 global_feat_dim=8, pyr_levels=1, gs_add_ratio=1.0, init_proba_scaler=4.0)
    jsm = JS.SceneModel(W, H, K, JMapperConfig(**sizes), seed=0)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    img = np.stack([0.5 + 0.4 * np.sin(u / 5.0), 0.5 + 0.4 * np.cos(v / 4.0),
                    0.5 + 0.3 * np.sin((u + v) / 7.0)]).astype(np.float32).clip(0, 1)
    depth = np.full((H, W), 2.0, np.float32)
    pm = np.stack([(u - W / 2) / F * depth, (v - H / 2) / F * depth, depth],
                  -1).astype(np.float32)
    kf = JKF.make_host_keyframe(index=0, global_frame_id=0, image=img, point_map=pm,
                                point_conf=np.ones((H, W), np.float32), is_test=False,
                                is_slam_keyframe=True, pyr_levels=1)
    jsm.add_keyframe(kf, np.eye(4, dtype=np.float32))
    jsm.add_new_gaussians(0)
    assert jsm.n_active_gaussians > 50
    sm = TS.SceneModel(W, H, K, MapperConfig(**sizes), device=CPU)
    sm.load_state(scene_state_from_numpy(jax_scene_state(jsm), CPU))
    return jsm, sm


def test_sharded_render_from_id_matches_single_device_and_jax():
    jsm, sm = _core_scene()
    single = sm.render_from_id(0)
    sm.enable_mesh(Mesh([CPU] * N_SLOTS))
    sharded = sm.render_from_id(0)
    assert (sm.n_renders, sm.n_sharded_renders) == (1, 1)
    np.testing.assert_allclose(n(sharded["render"]), n(single["render"]), atol=3e-5)
    np.testing.assert_allclose(n(sharded["invdepth"]), n(single["invdepth"]), atol=1e-3)
    np.testing.assert_array_equal(n(sharded["visibility"]), n(single["visibility"]))
    np.testing.assert_array_equal(n(sharded["global_visibility"]),
                                  n(single["global_visibility"]))
    assert int(sharded["visibility"].sum()) > 50

    jsm.enable_mesh(_jmesh("dp"))
    jsharded = jsm.render_from_id(0)
    np.testing.assert_allclose(n(sharded["render"]), n(jsharded["render"]), atol=3e-5)
    np.testing.assert_allclose(n(sharded["invdepth"]), n(jsharded["invdepth"]), atol=1e-3)
    jvis = n(jsharded["visibility"])
    L = sharded["visibility"].shape[0]      # the port renders the training prefix
    np.testing.assert_array_equal(n(sharded["visibility"]), jvis[:L])
    assert not jvis[L:].any()

    # the raw splats over the mesh against one device's render of them.
    # Raw scales reach radii of 58 px here: footprints span the 4-tile cap,
    # and the JAX package's strips box them in the strip's tiles, so its
    # render departs from the single one near the seams; the port boxes
    # them in the image's (parallel/splats.py) and matches it everywhere
    render, alpha = sm.render_sharded(0)
    s = sm.slab
    ref, ref_alpha, meta = tapi.rasterization(
        s.xyz, s.rotation, torch.exp(s.scaling), torch.sigmoid(s.opacity[:, 0]),
        torch.cat([s.f_dc, s.f_rest], 1), TS.KF.get_Rt(sm.pool, 0), sm._K_at_lvl(0),
        sm.width, sm.height, sh_degree=1, eps2d=sm.cfg.low_pass_filter_eps,
        valid_mask=s.active)
    assert float(meta.radii.max()) > 32
    np.testing.assert_allclose(n(render), n(ref), atol=2e-5)
    np.testing.assert_allclose(n(alpha), n(ref_alpha), atol=2e-5)
    j_render, _ = jsm.render_sharded(0)
    same = (np.abs(np.asarray(j_render) - n(ref)) <= 2e-5).all(axis=(1, 2))
    assert same.sum() >= sm.height // 2
    np.testing.assert_allclose(n(render)[same], np.asarray(j_render)[same], atol=2e-5)


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

DP_W, DP_H = 64, 48
DP_SIZES = dict(capacity=4096, cluster_capacity=1024, voxel_table_size=4096, new_budget=1024,
                keyframe_capacity=64, sh_degree=1, local_feat_dim=8, global_feat_dim=8,
                pyr_levels=2, gs_add_ratio=1.0, init_proba_scaler=4.0)


@pytest.fixture(scope="module")
def dp_scene():
    """Five keyframes of the synthetic plane stream in the JAX mapper
    (frame 4 a test frame), two densified; random global and local
    features make the mlp input nontrivial, every pose lr is 1e-4 (pose
    steps on every row).  Returns the JAX SceneModel, the state as numpy,
    and each keyframe's (gt, mono) at the training level."""
    args = types.SimpleNamespace(test_hold=4, max_size_slam=DP_W)
    ds = JSyntheticDataset(args, n_frames=5, width=DP_W, height=DP_H)
    tds = SyntheticDataset(args, n_frames=5, width=DP_W, height=DP_H)
    jcfg = JMapperConfig(**DP_SIZES)
    jsm = JS.SceneModel(DP_W, DP_H, ds.K_map, jcfg, seed=0)
    for m in exact_mapper_messages(tds):
        i = m["frame_id"]
        jkf = JKF.make_device_keyframe(
            index=i, global_frame_id=i, image=ds.transform.to_map(ds[i][0]),
            point_map=m["point_map"], point_conf=m["point_conf"], is_test=m["is_test"],
            is_slam_keyframe=m["is_slam_keyframe"], pyr_levels=jcfg.pyr_levels)
        jsm.add_keyframe(jkf, _se3_w2c_matrix_np(m["T_WC"][:7]))
        if i in (0, 2):
            jsm.add_new_gaussians(i)
    assert [kf.is_test for kf in jsm.keyframes] == [False] * 4 + [True]
    rng = np.random.default_rng(7)
    state = jax_scene_state(jsm)
    state["slab"]["local_feat"] = (0.3 * rng.normal(size=state["slab"]["local_feat"].shape)
                                   ).astype(np.float32)
    state["gfeat"]["val"] = (0.3 * rng.normal(size=state["gfeat"]["val"].shape)
                             ).astype(np.float32)
    state["pool"]["lr_pose"] = np.full_like(state["pool"]["lr_pose"], 1e-4)
    jsm.slab = dataclasses.replace(jsm.slab, local_feat=jnp.asarray(state["slab"]["local_feat"]))
    jsm.gfeat = dataclasses.replace(jsm.gfeat, val=jnp.asarray(state["gfeat"]["val"]))
    jsm.pool = dataclasses.replace(jsm.pool, lr_pose=jnp.asarray(state["pool"]["lr_pose"]))
    lvl = jcfg.pyr_levels - 1
    views = [tuple(np.asarray(x) for x in jsm._device_kf(i, lvl)) for i in range(5)]
    assert jsm.n_active_gaussians > 200
    return jsm, state, views


def _step_close(tp, jp, jm1, lr, cfg, name):
    """Parameters after one Adam step from zero moments.  Where the
    gradient is resolved by the gradient check (above 1e-4 of the group's
    largest, read from the first moment ``jm1``), atol 2e-5 / rtol 1e-4.
    Below it, Adam's eps of 1e-15 still turns a gradient of 1e-13 into a
    step of up to lr (1 - b1) / sqrt(1 - b2), whose size follows the
    gradient's own rounding (the four slots' sums cancel there): those
    elements are held to that step."""
    resolved = np.abs(jm1) > 1e-4 * max(np.abs(jm1).max(), 1e-30)
    d = np.abs(tp - jp)
    ok = d <= 2e-5 + 1e-4 * np.abs(jp)
    assert ok[resolved].all(), (name, int((~ok & resolved).sum()), float(d[resolved].max()))
    full_step = lr * (1 - cfg.adam_b1) / np.sqrt(1 - cfg.adam_b2)
    assert (d[~resolved] <= full_step).all(), (name, float(d.max()), full_step)


DP_CASES = {
    "distinct": ([0, 1, 2, 3], True),
    "duplicated": ([0, 1, 1, 2], True),       # keyframe 1 on two slots
    "one_test": ([0, 1, 2, 4], True),
    "all_test": ([4, 4, 4, 4], True),
    "common": ([3, 0, 2, 1], False),          # is_important=False: error masking
}


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_step_matches_jax(dp_scene, case):
    jsm, state, views = dp_scene
    ids, is_important = DP_CASES[case]
    lvl = DP_SIZES["pyr_levels"] - 1
    w, h = DP_W >> lvl, DP_H >> lvl
    Kl = np.asarray(jsm._K_at_lvl(lvl))
    bg = np.random.default_rng(3).uniform(size=(N_SLOTS, 3)).astype(np.float32)
    gt = np.stack([views[i][0] for i in ids])
    mono = np.stack([views[i][1] for i in ids])

    jstep = jdp.make_dp_train_step(_jmesh("dp"), JMapperConfig(**DP_SIZES), w, h,
                                   is_important=is_important)
    jout = jstep(jsm.slab, jsm.opt, jsm.gfeat, jsm.mlp, jsm.mlp_opt, jsm.mlp_lr, jsm.pool,
                 jnp.asarray(ids, jnp.int32), jnp.asarray(gt), jnp.asarray(mono),
                 jnp.asarray(Kl), jnp.asarray(bg))
    st = scene_state_from_numpy(state, CPU)
    mesh = Mesh([CPU] * N_SLOTS)
    step = tdp.make_dp_train_step(mesh, MapperConfig(**DP_SIZES), w, h,
                                  is_important=is_important)
    tout = step(st.slab, st.opt, st.gfeat, st.mlp, st.mlp_opt, st.mlp_lr, st.pool, ids,
                t(gt), t(mono), t(Kl), t(bg))
    t_slab, t_opt, t_gfeat, t_mlp, t_mlp_opt, t_mlp_lr, t_pool, tm = tout
    j_slab, j_opt, j_gfeat, j_mlp, j_mlp_opt, j_mlp_lr, j_pool, jm = jout

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(t_mlp_lr) == float(j_mlp_lr)
    if case == "all_test":
        # no scene, global-feature or mlp update, and the mlp lr unchanged
        assert float(t_mlp_lr) == float(st.mlp_lr)
        for k in TG.TRAINED_KEYS:
            assert getattr(t_slab, k) is getattr(st.slab, k)
        assert t_gfeat is st.gfeat and t_mlp is st.mlp
    else:
        assert float(t_mlp_lr) < float(st.mlp_lr)
        cfg = MapperConfig(**DP_SIZES)
        lrs = dict(xyz=cfg.position_lr_init, f_dc=cfg.feature_lr,
                   f_rest=cfg.feature_lr / 20.0, scaling=cfg.scaling_lr,
                   rotation=cfg.rotation_lr, opacity=cfg.opacity_lr,
                   local_feat=cfg.feat_lr, gfeat=cfg.feat_lr)
        vis = n(j_opt.xyz.exp_avg_sq).max(-1) > 0      # rows the step touched
        assert vis.sum() > 100
        groups = [(k, getattr(t_slab, k), getattr(j_slab, k), t_opt[k].exp_avg,
                   getattr(j_opt, k).exp_avg, lrs[k]) for k in TG.TRAINED_KEYS]
        groups.append(("gfeat", t_gfeat.val, j_gfeat.val, t_gfeat.opt.exp_avg,
                       j_gfeat.opt.exp_avg, lrs["gfeat"]))
        groups += [(k, getattr(t_mlp, k), getattr(j_mlp, k), t_mlp_opt[k].exp_avg,
                    j_mlp_opt[k].exp_avg, float(st.mlp_lr)) for k in TS.MLP_KEYS]
        for k, tp, jp, tm1, jm1, lr in groups:
            _close_rel(tm1, jm1, 1e-4, k)
            _step_close(n(tp), n(jp), n(jm1), lr, cfg, k)
        np.testing.assert_allclose(n(t_slab.xyz_lr), n(j_slab.xyz_lr), rtol=1e-6)
    # the pool's rows: every trained row moved, the rest did not
    for f in ("r_w2c", "t_w2c", "exposure", "depth_loss_weight"):
        np.testing.assert_allclose(n(getattr(t_pool, f)), n(getattr(j_pool, f)),
                                   rtol=1e-4, atol=2e-5, err_msg=f)
    for f in ("opt_r", "opt_t", "opt_e"):
        for a, b in zip(getattr(t_pool, f), getattr(j_pool, f)):
            _close_rel(a, b, 1e-4, f)
    moved = n(t_pool.depth_loss_weight) != n(st.pool.depth_loss_weight)
    np.testing.assert_array_equal(np.flatnonzero(moved), sorted(set(ids)))
    assert float(np.abs(n(t_pool.t_w2c) - n(st.pool.t_w2c))[ids].max()) > 0


# ---------------------------------------------------------------------------
# the edge-sharded GN
# ---------------------------------------------------------------------------

def test_sharded_gn_matches_jax_and_unsharded():
    """_recover_problem (4 poses, 8 edge rows, 4 of them real): 2 edges a
    slot, the last two slots holding padding only."""
    T_gt, T0, prob, kw = _recover_problem()
    Xp, Cp, ii, jj, idx_p, vm_p, Q_p, ev, used = prob
    arrays = (T0, Xp, Cp, GK, ii, jj, idx_p, vm_p, Q_p, ev, used)
    kw = {k: v for k, v in kw.items() if k != "chunk"}
    Tj = np.asarray(jgo.gauss_newton_calib_sharded(
        _jmesh("dp"), "dp", *(jnp.asarray(a) for a in arrays), GH, GW, **kw))
    mesh = Mesh([CPU] * N_SLOTS)
    Ts = n(go.gauss_newton_calib_sharded(mesh, "dp", *(t(a) for a in arrays), GH, GW, **kw))
    Tu = n(go.gauss_newton_calib(*(t(a) for a in arrays), GH, GW, chunk=8, **kw))
    np.testing.assert_array_equal(Ts[0], T0[0])              # pinned
    for i in range(len(T_gt)):
        assert _pose_err(Ts[i], Tj[i]) < 1e-4, i
        assert _pose_err(Ts[i], Tu[i]) < 1e-4, i
        assert _pose_err(Ts[i], T_gt[i]) < 0.45 * _pose_err(T0[i], T_gt[i]) or i == 0
    # an edge pad that does not divide over the slots
    six = tuple(a[:6] for a in (ii, jj, idx_p, vm_p, Q_p, ev))
    with pytest.raises(ValueError, match="not divisible"):
        go.gauss_newton_calib_sharded(mesh, "dp", *(t(a) for a in (T0, Xp, Cp, GK, *six,
                                                                   used)), GH, GW, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        jgo.gauss_newton_calib_sharded(_jmesh("dp"), "dp", *(jnp.asarray(a) for a in (
            T0, Xp, Cp, GK, *six, used)), GH, GW, **kw)


# ---------------------------------------------------------------------------
# System with --n_devices 4, and the entry point
# ---------------------------------------------------------------------------

SYS_SIZES = dict(capacity=4096, cluster_capacity=1024, voxel_table_size=4096,
                 new_budget=1024, keyframe_capacity=64, sh_degree=1, local_feat_dim=8,
                 global_feat_dim=8, pyr_levels=1, gs_add_ratio=1.0, init_proba_scaler=4.0)


def _config(load):
    cfg = load(os.path.join(REPO, "config", "base.yaml"))
    cfg["matching"].update(radius=1, dilation_max=1, dist_thresh=0.05)
    return cfg


def test_system_4_slots_matches_jax():
    """``test_system_multichip_dp``'s settings (8 frames at 160x120, 2 key
    and 1 common iteration) with 4 slots in both packages; the port's
    mapper starts from the JAX mapper's initial state and noise."""
    args = _args(n_devices=N_SLOTS, num_key_iterations=2, num_common_iterations=1)
    if len(jax.devices()) < N_SLOTS:
        pytest.skip("needs the virtual CPU devices of conftest.py")
    jds = JSyntheticDataset(args, n_frames=8, width=160, height=120)
    jcfg = _config(jload_config)
    jrunner = JOracleRunner((jds.H_slam, jds.W_slam), jds.K_slam, jcfg["matching"])
    register(jrunner, jds)
    jsys = JSystem(args, jcfg, jds, jrunner, mapper_cfg=JMapperConfig(**SYS_SIZES))
    jsm = jsys.scene_model
    j_steps = []
    j_dp = jsm._optimization_step_dp
    jsm._optimization_step_dp = lambda **kw: (j_steps.append(1), j_dp(**kw))[1]

    ds = SyntheticDataset(args, n_frames=8, width=160, height=120)
    cfg = _config(load_config)
    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=CPU)
    register(runner, ds)
    tsys = System(args, cfg, ds, runner, mapper_cfg=MapperConfig(**SYS_SIZES), device=CPU,
                  noise=JaxKeyChain(0))
    tsys.scene_model.load_state(scene_state_from_numpy(jax_scene_state(jsm), CPU))
    tsm = tsys.scene_model
    assert tsm._mesh is not None and tsm._mesh.size == jsm._mesh.size == N_SLOTS
    assert tsys.backend.factor_graph.mesh is tsm._mesh
    jsys.run(progress=False)
    tsys.run(progress=False)

    assert tsys.frontend.lost_number == jsys.frontend.lost_number == 0
    n_kf = len(tsys.keyframes)
    assert n_kf == len(jsys.keyframes) >= 1
    np.testing.assert_array_equal(tsys.keyframes.dataset_idx[:n_kf],
                                  jsys.keyframes.dataset_idx[:n_kf])
    np.testing.assert_allclose(tsys.keyframes.T_WC[:n_kf], jsys.keyframes.T_WC[:n_kf],
                               atol=1e-4)
    np.testing.assert_allclose(tsys.frontend.estimated_trajectory(),
                               jsys.frontend.estimated_trajectory(), atol=1e-4)
    assert tsm.n_dp_steps == len(j_steps) > 0 and tsm._dp_steps
    assert tsm.n_train_steps == 0
    assert tsm.last_trained_id == jsm.last_trained_id
    assert tsm.n_active_gaussians == jsm.n_active_gaussians > 100
    np.testing.assert_allclose(n(tsm.pool.t_w2c), np.asarray(jsm.pool.t_w2c), atol=1e-4)


def test_run_system_n_devices_on_the_cpu(monkeypatch, tmp_path):
    """``run_system --n_devices 4 --device cpu`` trains through the dp
    step, on a mesh of 4 CPU slots."""
    from artdeco_tpu_torch import run_system
    from artdeco_tpu_torch.runtime import system as tsystem

    ran = []
    run = tsystem.System.run
    monkeypatch.setattr(tsystem.System, "run",
                        lambda self, *a, **k: (ran.append(self), run(self, *a, **k))[1])
    meta = run_system.main([
        "-s", "synthetic://", "-d", "synthetic", "--oracle", "--device", "cpu",
        "--n_devices", str(N_SLOTS), "--max_size_slam", "64", "--downsampling", "4",
        "--test_hold", "4", "--num_key_iterations", "2", "--sh_degree", "1",
        "--local_feat_dim", "8", "--global_feat_dim", "8", "--pyr_levels", "1",
        "--retrieval_checkpoint_path", "", "-m", str(tmp_path / "run")])
    sm = ran[0].scene_model
    assert sm._mesh.devices == (CPU,) * N_SLOTS
    assert sm.n_dp_steps > 0 and sm.n_train_steps == 0
    assert meta["n_frames"] == 30 and meta["n_gaussians"] > 0
