"""Parity of the PyTorch mapper modules with the JAX ones, on the CPU.

SSIM, Adam, the losses (with the resize trap), the Gaussian slab, the
keyframe pool and pyramids, the voxel clustering, and one training
iteration from one state carried across by ``state_io``.  The same numpy
inputs go through both packages; each tolerance says why it is what it is.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from artdeco_tpu.mapper import clustering as jclu
from artdeco_tpu.mapper import gaussians as JG
from artdeco_tpu.mapper import keyframe as JKF
from artdeco_tpu.mapper import losses as jlo
from artdeco_tpu.mapper import scene_model as JS
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.ops import adam as jadam
from artdeco_tpu.ops import ssim as jssim
from artdeco_tpu_torch.mapper import clustering as tclu
from artdeco_tpu_torch.mapper import gaussians as TG
from artdeco_tpu_torch.mapper import keyframe as TKF
from artdeco_tpu_torch.mapper import losses as tlo
from artdeco_tpu_torch.mapper import scene_model as TS
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.state_io import scene_state_from_numpy
from artdeco_tpu_torch.ops import adam as tadam
from artdeco_tpu_torch.ops import ssim as tssim
from torch_parity import CPU, jax_scene_state, n, t, torch_threads  # noqa: F401

W, H = 64, 48
SIZES = dict(
    capacity=4096, cluster_capacity=1024, voxel_table_size=4096, new_budget=1024,
    keyframe_capacity=64, sh_degree=1, local_feat_dim=8, global_feat_dim=8,
    pyr_levels=2, gs_add_ratio=1.0, init_proba_scaler=4.0,
)
CFG, JCFG = MapperConfig(**SIZES), JMapperConfig(**SIZES)  # the port's, the JAX package's


def test_ssim_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, H, W)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ta = t(a).requires_grad_()
    s = tssim.fused_ssim(ta, t(b))
    s.backward()
    jg = jax.grad(jssim.fused_ssim)(a, b)
    # float32 box sums in another order: 1e-6 on values of order 1
    np.testing.assert_allclose(float(s.detach()), float(jssim.fused_ssim(a, b)), atol=1e-6)
    np.testing.assert_allclose(n(tssim.ssim_map(t(a), t(b), "valid")),
                               n(jssim.ssim_map(a, b, "valid")), atol=1e-5)
    np.testing.assert_allclose(n(ta.grad), n(jg), atol=1e-5 * np.abs(n(jg)).max())


def test_adam_matches_jax():
    rng = np.random.default_rng(1)
    p, g, m, v = (rng.normal(size=(20, 3)).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    vis = rng.uniform(size=20) > 0.4
    lr_rows = rng.uniform(0.001, 0.01, 20).astype(np.float32)
    jst, tst = jadam.AdamState(m, v), tadam.AdamState(t(m), t(v))
    # elementwise float32 with the same operation order: a few ulps
    for lr in (0.01, lr_rows):
        jp, js = jadam.adam_update_masked(p, g, jst, lr, vis, b1=0.5, b2=0.99)
        tp, ts = tadam.adam_update_masked(t(p), t(g), tst, t(lr) if
                                          isinstance(lr, np.ndarray) else lr, t(vis),
                                          b1=0.5, b2=0.99)
        np.testing.assert_allclose(n(tp), n(jp), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(n(ts.exp_avg_sq), n(js.exp_avg_sq), rtol=1e-6)
        assert (n(tp)[~vis] == p[~vis]).all()
    jp, js = jadam.adam_update_basic(p, g, jst, 0.003, b1=0.8, b2=0.99)
    tp, ts = tadam.adam_update_basic(t(p), t(g), tst, 0.003, b1=0.8, b2=0.99)
    np.testing.assert_allclose(n(tp), n(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(ts.exp_avg), n(js.exp_avg), rtol=1e-6)
    np.testing.assert_allclose(
        n(tadam.decay_lr_masked(t(lr_rows), t(vis), 0.9, 0.004)),
        n(jadam.decay_lr_masked(lr_rows, vis, 0.9, 0.004)), rtol=1e-7)


@pytest.mark.parametrize("hw_in,hw_out", [((24, 32), (48, 64)), ((24, 32), (24, 32)),
                                          ((48, 64), (24, 32)), ((48, 64), (12, 16)),
                                          ((48, 64), (6, 8))])
def test_resize_bilinear_is_jax_image_resize(hw_in, hw_out):
    """The trap: the JAX docstring says align_corners=True, but
    jax.image.resize(bilinear) uses half-pixel centres and antialiases when
    it downsamples.  The port matches what JAX computes (float32 weight
    sums in another order: 1e-6), at the sizes densify uses."""
    img = np.random.default_rng(2).uniform(size=(3,) + hw_in).astype(np.float32)
    ref = n(jlo.resize_bilinear(img, *hw_out))
    np.testing.assert_allclose(n(tlo.resize_bilinear(t(img), *hw_out)), ref, atol=1e-6)
    if hw_in != hw_out:
        ac = n(F.interpolate(t(img)[None], size=hw_out, mode="bilinear",
                             align_corners=True)[0])
        assert np.abs(ac - ref).max() > 0.05  # what the docstring claims is wrong


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(3, H, W)).astype(np.float32)
    np.testing.assert_allclose(n(tlo.radial_decay_kernel(H, W, 5 ** 0.5)),
                               n(jlo.radial_decay_kernel(H, W, 5 ** 0.5)), atol=1e-6)
    disc = jlo.disc_kernel(3)
    np.testing.assert_array_equal(n(tlo.disc_kernel(3)), n(disc))
    # 3x3 Laplacian then a 7x7 disc average, sums in another order
    np.testing.assert_allclose(n(tlo.lapla_norm(t(img), tlo.disc_kernel(3))),
                               n(jlo.lapla_norm(img, disc)), atol=2e-6)
    np.testing.assert_allclose(n(tlo.avg_pool2(t(img))), n(jlo.avg_pool2(img)),
                               atol=1e-7)
    img2 = np.clip(img + 0.05, 0, 1)
    # the MSE is summed in another order: ~1e-5 relative, 1e-4 dB
    np.testing.assert_allclose(float(tlo.psnr(t(img), t(img2))),
                               float(jlo.psnr(img, img2)), atol=1e-4)
    uv = np.c_[rng.uniform(-2, W + 2, 200), rng.uniform(-2, H + 2, 200)].astype(np.float32)
    uv[:4] = [[0, 0], [W - 1, H - 1], [10, 7], [W - 1, 0]]
    np.testing.assert_allclose(n(tlo.grid_sample_bilinear(t(img), t(uv))),
                               n(jlo.grid_sample_bilinear(img, uv)), atol=1e-6)
    # constant maps sample to exactly the constant (voxel ids depend on it)
    const = np.full((1, H, W), 2.0, np.float32)
    assert (n(tlo.grid_sample_bilinear(t(const), t(uv * 0.37))) == 2.0).all()


def _candidates(rng, b, valid_frac=0.7):
    new = dict(
        xyz=rng.normal(size=(b, 3)).astype(np.float32),
        opacity=rng.normal(size=(b, 1)).astype(np.float32),
        kf_id=np.full(b, 3, np.int32),
        d_max=rng.uniform(1, 3, (b, 1)).astype(np.float32),
    )
    return new, rng.uniform(size=b) < valid_frac


def test_gaussians_insert_prune_grow_match_jax():
    rng = np.random.default_rng(4)
    js = JG.create_slab(64, 1, 4, 1e-4)
    jo = JG.create_opt_state(js)
    ts = TG.create_slab(64, 1, 4, 1e-4, CPU)
    to = TG.create_opt_state(ts)

    def same():
        for f in dataclasses.fields(ts):
            np.testing.assert_array_equal(n(getattr(ts, f.name)), n(getattr(js, f.name)),
                                          err_msg=f.name)
        for k in TG.TRAINED_KEYS:
            np.testing.assert_array_equal(n(to[k].exp_avg), n(getattr(jo, k).exp_avg))

    for step in range(4):
        new, valid = _candidates(rng, 30)
        js, jo, jn = JG.insert(js, jo, {k: jnp.asarray(v) for k, v in new.items()},
                               jnp.asarray(valid))
        ts, to, tn = TG.insert(ts, to, {k: t(v) for k, v in new.items()}, t(valid))
        assert int(tn) == int(jn)
        same()
        keep = rng.uniform(size=ts.capacity) > 0.3
        js, ts = JG.prune(js, jnp.asarray(keep)), TG.prune(ts, t(keep))
        same()
        if step == 1:  # lowest free slots first, in order; then grow
            js, jo = JG.grow(js, jo, 128)
            ts, to = TG.grow(ts, to, 128)
            same()
    # masked Adam + lr decay over the slab fields (a few ulps)
    grads = {k: rng.normal(size=getattr(ts, k).shape).astype(np.float32)
             for k in TG.TRAINED_KEYS}
    vis = rng.uniform(size=ts.capacity) > 0.5
    lrs = dict(f_dc=0.005, f_rest=0.00025, scaling=0.01, rotation=0.002,
               opacity=0.1, local_feat=0.004)
    js2, _ = JG.apply_adam(js, jo, {k: jnp.asarray(g) for k, g in grads.items()},
                           jnp.asarray(vis), lrs, 0.5, 0.99, 1e-15)
    ts2, _ = TG.apply_adam(ts, to, {k: t(g) for k, g in grads.items()}, t(vis), lrs,
                           0.5, 0.99, 1e-15)
    for k in TG.TRAINED_KEYS:
        np.testing.assert_allclose(n(getattr(ts2, k)), n(getattr(js2, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        n(TG.decay_xyz_lr(ts, t(vis), 0.9, 1e-5).xyz_lr),
        n(JG.decay_xyz_lr(js, jnp.asarray(vis), 0.9, 1e-5).xyz_lr), rtol=1e-7)


def test_keyframe_pool_and_pyramids_match_jax():
    rng = np.random.default_rng(5)
    r6 = rng.normal(size=(5, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(n(TKF.sixd_to_mtx(t(r6))), n(JKF.sixd_to_mtx(r6)),
                               atol=1e-6)
    R = n(TKF.sixd_to_mtx(t(r6)))
    np.testing.assert_allclose(n(TKF.sixd_to_mtx(TKF.mtx_to_sixd(t(R)))), R, atol=1e-6)

    jp = JKF.create_pool(8)
    tp = TKF.create_pool(8, CPU)
    for idx in range(3):
        Rt = np.eye(4, dtype=np.float32)
        Rt[:3, :3] = R[idx]
        Rt[:3, 3] = rng.normal(size=3)
        jp = JKF.register_keyframe(jp, idx, jnp.asarray(Rt), 1e-4, 5e-4, 1e-2, idx == 2)
        TKF.register_keyframe(tp, idx, t(Rt), 1e-4, 5e-4, 1e-2, idx == 2)
        # the next keyframe inherits this exposure
        tp.exposure[idx] += 0.01 * (idx + 1)
        jp = dataclasses.replace(jp, exposure=jp.exposure.at[idx].add(0.01 * (idx + 1)))
    for f in dataclasses.fields(tp):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        pairs = zip(a, b) if f.name.startswith("opt_") else [(a, b)]
        for x, y in pairs:
            np.testing.assert_allclose(n(x), n(y), atol=1e-7, err_msg=f.name)
    np.testing.assert_allclose(n(TKF.get_Rt(tp, 1)), n(JKF.get_Rt(jp, 1)), atol=1e-6)
    np.testing.assert_allclose(n(TKF.cam_centres(tp)), n(JS._cam_centres_jit(jp)),
                               atol=1e-6)

    # pyramids: SLAM-res pointmap resized (align_corners=True) to map res,
    # then 2x average pooling
    img = rng.uniform(size=(3, H, W)).astype(np.float32)
    pm = rng.uniform(1, 3, (36, 52, 3)).astype(np.float32)
    pm[0, 0, 2] = 0.0  # inverse depth of a hole
    conf = rng.uniform(size=(36, 52)).astype(np.float32)
    jpyr = JKF._build_pyramids_jit(jnp.asarray(img), jnp.asarray(pm), jnp.asarray(conf),
                                   2, H, W)
    tkf = TKF.make_device_keyframe(0, 0, img, pm, conf, False, True, CPU, pyr_levels=2)
    assert tkf.pyr_lvl == 1
    # the grid positions (linspace) differ from XLA's by an ulp at some
    # rows, which moves bilinear weights by ~1e-5 on values of order 1
    for tl_, jl_ in zip((tkf.image_pyr, tkf.idepth_pyr, tkf.conf_pyr), jpyr):
        for a, b in zip(tl_, jl_):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-5)


def test_clustering_matches_jax():
    """Integer hashing and votes: identical ids, table and counts."""
    rng = np.random.default_rng(6)
    nn, b = 300, 200
    js, ts = jclu.create_cluster_state(4096), tclu.create_cluster_state(4096, CPU)
    xyz = (rng.normal(size=(nn, 3)) * 0.3).astype(np.float32)
    xyz[:3] = [[1e6, -1e6, 3e5]] * 3  # large voxel indices wrap in int32
    np.testing.assert_array_equal(n(tclu.bucket_of(t(xyz), 0.1, 4096)),
                                  n(jclu.bucket_of(jnp.asarray(xyz), 0.1, 4096)))
    cls = rng.integers(0, 20, nn).astype(np.int32)
    active = rng.uniform(size=nn) > 0.3
    for _ in range(3):
        nx = (rng.normal(size=(b, 3)) * 0.3).astype(np.float32)
        nv = rng.uniform(size=b) > 0.2
        jo = jclu.update_clusters(js, jnp.asarray(xyz), jnp.asarray(cls),
                                  jnp.asarray(active), jnp.asarray(nx), jnp.asarray(nv),
                                  0.1, 4096, 1024)
        to = tclu.update_clusters(ts, t(xyz), t(cls), t(active), t(nx), t(nv),
                                  0.1, 4096, 1024)
        for a, b_ in zip((to[0].voxel_cls, to[0].num_clusters, *to[1:]),
                         (jo[0].voxel_cls, jo[0].num_clusters, *jo[1:])):
            np.testing.assert_array_equal(n(a), n(b_))
        js, ts, cls = jo[0], to[0], n(to[1])
        xyz = (xyz + 0.05 * rng.normal(size=xyz.shape)).astype(np.float32)


def _plane_keyframe():
    from artdeco_tpu_torch.runtime.system import exact_mapper_messages

    ds = SyntheticDataset(types.SimpleNamespace(test_hold=0, max_size_slam=64),
                          n_frames=1, width=W, height=H)
    m = next(exact_mapper_messages(ds))
    return ds, m, ds.transform.to_map(ds[0][0])


@pytest.mark.parametrize("is_important", [True, False])
def test_train_iter_matches_jax(is_important):
    """One iteration from one state: the JAX mapper densifies a keyframe,
    random global and local features make the mlp input nontrivial, and
    state_io carries the whole state across.  A single step compares
    tightly: gradients (read from the first Adam moment, which is
    (1 - b1) * g after one step from zero) to 1e-4 of each group's largest
    entry, and updated parameters to atol 2e-5 / rtol 1e-4."""
    ds, m, img = _plane_keyframe()
    jsm = JS.SceneModel(W, H, ds.K_map, JCFG, seed=0)
    jkf = JKF.make_device_keyframe(index=0, global_frame_id=0, image=img,
                                   point_map=m["point_map"], point_conf=m["point_conf"],
                                   is_test=False, is_slam_keyframe=True,
                                   pyr_levels=CFG.pyr_levels)
    Rt = np.eye(4, dtype=np.float32)
    jsm.add_keyframe(jkf, Rt)
    jsm.add_new_gaussians()
    rng = np.random.default_rng(7)
    state = jax_scene_state(jsm)
    state["slab"]["local_feat"] = (0.3 * rng.normal(size=state["slab"]["local_feat"].shape)
                                   ).astype(np.float32)
    state["gfeat"]["val"] = (0.3 * rng.normal(size=state["gfeat"]["val"].shape)
                             ).astype(np.float32)
    state["pool"]["lr_pose"] = np.full_like(state["pool"]["lr_pose"], 1e-4)  # pose steps too
    jsm.slab = dataclasses.replace(jsm.slab, local_feat=jnp.asarray(state["slab"]["local_feat"]))
    jsm.gfeat = dataclasses.replace(jsm.gfeat, val=jnp.asarray(state["gfeat"]["val"]))
    jsm.pool = dataclasses.replace(jsm.pool, lr_pose=jnp.asarray(state["pool"]["lr_pose"]))
    st = scene_state_from_numpy(state, CPU)
    assert st.train_len == jsm._train_len

    lvl = CFG.pyr_levels - 1
    w, h = W >> lvl, H >> lvl
    Kl = np.asarray(jsm._K_at_lvl(lvl))
    bg = np.array([0.3, 0.6, 0.1], np.float32)
    gt, mono = jsm._device_kf(0, lvl)
    out = JS.optimization_step_core(
        jsm.slab, jsm.opt, jsm.gfeat, jsm.mlp, jsm.mlp_opt, jsm.mlp_lr, jsm.pool,
        jnp.asarray(0), gt, mono, jnp.asarray(Kl), jnp.asarray(bg), jnp.asarray(False),
        w, h, lvl, is_important, JCFG, train_len=jsm._train_len)
    tkf = TKF.make_device_keyframe(0, 0, img, m["point_map"], m["point_conf"], False,
                                   True, CPU, pyr_levels=CFG.pyr_levels)
    np.testing.assert_array_equal(n(tkf.image_pyr[lvl]), n(gt))
    r = TS._train_iter(st.slab, st.opt, st.gfeat, st.mlp, st.mlp_opt, st.mlp_lr,
                       st.pool, 0, tkf.image_pyr[lvl], tkf.idepth_pyr[lvl], t(Kl), t(bg),
                       False, w, h, is_important, CFG)
    t_slab, t_opt, t_gfeat, t_mlp, t_mlp_opt, t_mlp_lr, t_pool, metrics, grads = r
    j_slab, j_opt, j_gfeat, j_mlp, j_mlp_opt, j_mlp_lr, j_pool, j_metrics = out
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    assert int(metrics["n_vis"]) == int(j_metrics["n_vis"]) > 100

    def grad_close(tg, jm, b1, name):
        jg = n(jm) / (1.0 - b1)
        np.testing.assert_allclose(n(tg), jg, rtol=0,
                                   atol=1e-4 * max(np.abs(jg).max(), 1e-12), err_msg=name)

    vis = n(j_opt.xyz.exp_avg_sq).max(-1) > 0  # rows the step touched
    for k in TG.TRAINED_KEYS:
        grad_close(n(grads[k])[vis], n(getattr(j_opt, k).exp_avg)[vis], CFG.adam_b1, k)
        np.testing.assert_allclose(n(getattr(t_slab, k)), n(getattr(j_slab, k)),
                                   rtol=1e-4, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(n(t_slab.xyz_lr), n(j_slab.xyz_lr), rtol=1e-6)
    gv = n(j_gfeat.opt.exp_avg_sq).max(-1) > 0
    grad_close(n(grads["gfeat"])[gv], n(j_gfeat.opt.exp_avg)[gv], CFG.adam_b1, "gfeat")
    np.testing.assert_allclose(n(t_gfeat.val), n(j_gfeat.val), rtol=1e-4, atol=2e-5)
    for k in TS.MLP_KEYS:
        grad_close(grads["mlp." + k], j_mlp_opt[k].exp_avg, CFG.adam_b1, k)
        np.testing.assert_allclose(n(getattr(t_mlp, k)), n(getattr(j_mlp, k)),
                                   rtol=1e-4, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(float(t_mlp_lr), float(j_mlp_lr), rtol=1e-6)
    for name, st_name in (("r", "opt_r"), ("t", "opt_t"), ("e", "opt_e")):
        grad_close(grads[name], getattr(j_pool, st_name).exp_avg[0], 0.8, name)
    for f in ("r_w2c", "t_w2c", "exposure", "depth_loss_weight"):
        np.testing.assert_allclose(n(getattr(t_pool, f)), n(getattr(j_pool, f)),
                                   rtol=1e-4, atol=2e-5, err_msg=f)
