"""The port's keypoint-SfM bootstrap (``artdeco_tpu_torch/poses/``) against
the JAX package's ``artdeco_tpu/poses/``, on the CPU.

Tolerances (the measured gaps in brackets):

* ``mutual_nn`` on random unit descriptors: nearest neighbours and the
  mutual mask equal, similarities within 1e-6 [6e-8];
* RANSAC on ``test_poses``' two-view scene with 40 outliers, the same
  sample sets (``np.random.RandomState``): inlier mask and count equal,
  F / F[2, 2] within 1e-4 of its largest entry [< 1e-6], Sampson errors
  within 2e-3 relative [9.5e-4, on the outliers' errors of ~500 px^2,
  which amplify F's float32 differences] or 1e-6 absolute (the inliers'
  are ~1e-9, against a threshold of 1e-2);
* triangulation: points and depths within 5e-4 relative [1.2e-4; the
  midpoint divides by d11 d22 - d12^2, which cancels between rays a few
  degrees apart], disparities (1 - cos) within 1e-6 [1.8e-7], validity
  equal; guided MVS: depths within 1e-5 [1.4e-6], validity equal;
* PnP from a perturbed pose: within 1e-5 [< 1e-6]; mini-BA, points fixed
  and free: gauge-free quantities within 1e-5 (see the test);
* ``detect_keypoints``: keypoints equal, the zero-score ties in the JAX
  order included, on a seeded 64x48 image and on frame 0 of the 512x384
  synthetic stream [equal]; scores within 1e-5 relative [1.7e-6],
  descriptors within 1e-5 [3.7e-6].  (Frames 4
  and 5 of the stream hold two pairs of peaks whose responses differ by
  7e-12, which the two packages' blur sums order differently; frames 0
  and 8, which the bootstrap uses, hold none.)
* ``PoseInitializer.bootstrap`` on the synthetic frames 0..8: False, as
  in JAX, with the same counts: 689 mutual matches, 522 RANSAC inliers,
  0 points triangulated at the fixed baseline guess;
* registration against the bootstrap's points: the JAX package keys the
  points by their position in the bootstrap's match list and looks them
  up by keypoint index, so PnP gets the wrong 3D points when the two
  keyframes list their keypoints in different orders [its pose is off by
  33.5 in the Sim(3) log here]; the port keys them by keypoint index and
  recovers the pose within 1e-3 [9.0e-6].
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.geometry import lie as jlie
from artdeco_tpu.poses import feature_detector as jfd
from artdeco_tpu.poses import guided_mvs as jmvs
from artdeco_tpu.poses import matcher as jmatch
from artdeco_tpu.poses import mini_ba as jba
from artdeco_tpu.poses import pnp as jpnp
from artdeco_tpu.poses import pose_initializer as jpi
from artdeco_tpu.poses import ransac as jransac
from artdeco_tpu.poses import triangulator as jtri
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.mapper.keyframe import sixd_to_mtx
from artdeco_tpu_torch.poses import feature_detector as fd
from artdeco_tpu_torch.poses import guided_mvs, matcher, mini_ba, pnp, pose_initializer
from artdeco_tpu_torch.poses import ransac, triangulator
from test_poses import CENTRE, F, K, _two_view_scene
from torch_parity import CPU, n, t, torch_threads  # noqa: F401

TC, TK = t(CENTRE), t(K)


def test_mutual_nn_matches_jax():
    rng = np.random.RandomState(0)
    d1 = rng.randn(300, 32).astype(np.float32)
    d2 = np.concatenate([d1[::2] + 0.05 * rng.randn(150, 32), rng.randn(100, 32)]).astype(
        np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    jn, jm, js = jmatch.mutual_nn(jnp.asarray(d1), jnp.asarray(d2), 0.8)
    tn, tm, ts = matcher.mutual_nn(t(d1), t(d2), 0.8)
    np.testing.assert_array_equal(n(tn), n(jn))
    np.testing.assert_array_equal(n(tm), n(jm))
    np.testing.assert_allclose(n(ts), n(js), atol=1e-6)
    assert 100 < n(tm).sum() < 300


def test_ransac_matches_jax():
    X, uv1, uv2, R2, t2 = _two_view_scene(outliers=40)
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    jF, jin, jc = jransac.RANSACEstimator(N=256, max_error=1e-2).estimate(uv1, uv2)
    tF, tin, tc = ransac.RANSACEstimator(N=256, max_error=1e-2).estimate(t(uv1), t(uv2))
    assert int(tc) == int(jc) > 140
    np.testing.assert_array_equal(n(tin), n(jin))
    # both scale F to F[2, 2] = 1, which fixes the SVD's free sign
    np.testing.assert_allclose(n(tF), n(jF), atol=1e-4 * np.abs(n(jF)).max())
    np.testing.assert_allclose(n(ransac.sampson_error(tF, t(uv1), t(uv2))),
                               n(jransac.sampson_error(jF, jnp.asarray(uv1), jnp.asarray(uv2))),
                               rtol=2e-3, atol=1e-6)


def _rt(R2, t2):
    Rt1 = np.eye(4, dtype=np.float32)
    Rt2 = np.eye(4, dtype=np.float32)
    Rt2[:3, :3], Rt2[:3, 3] = R2, t2
    return Rt1, Rt2


def test_triangulation_and_guided_mvs_match_jax():
    X, uv1, uv2, R2, t2 = _two_view_scene()
    Rt1, Rt2 = _rt(R2, t2)
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    uv2[::7] = -1.0                       # missing matches
    jout = jtri.triangulate(jnp.asarray(uv1), jnp.asarray(uv2)[None], jnp.asarray(Rt1),
                            jnp.asarray(Rt2)[None], jnp.asarray(F), CENTRE, max_error=1e-2,
                            min_dis=1e-5)
    tout = triangulator.triangulate(t(uv1), t(uv2)[None], t(Rt1), t(Rt2)[None],
                                    torch.tensor(F), TC, max_error=1e-2, min_dis=1e-5)
    # points and depths through the midpoint's 1 / (d11 d22 - d12^2), which
    # cancels for rays 0.3 rad apart; disparities through 1 - cos
    np.testing.assert_allclose(n(tout[0]), n(jout[0]), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(n(tout[1]), n(jout[1]), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(n(tout[2]), n(jout[2]), atol=1e-6)
    np.testing.assert_array_equal(n(tout[3]), n(jout[3]))
    assert 0.8 < n(tout[3]).mean() < 0.9

    jd, jv = jmvs.guided_depth(jnp.asarray(uv1), jnp.asarray(uv2)[None], jnp.asarray(Rt1),
                               jnp.asarray(Rt2)[None], jnp.asarray(F), CENTRE)
    td, tv = guided_mvs.guided_depth(t(uv1), t(uv2)[None], t(Rt1), t(Rt2)[None],
                                     torch.tensor(F), TC)
    np.testing.assert_allclose(n(td), n(jd), atol=1e-5)
    np.testing.assert_array_equal(n(tv), n(jv))


def test_pnp_matches_jax():
    X, uv1, uv2, R2, t2 = _two_view_scene()
    T_gt = np.concatenate([t2, np.asarray(jlie.matrix_to_quat(jnp.asarray(R2, jnp.float32)))])
    xi = jnp.asarray([0.1, -0.05, 0.08, 0.05, -0.03, 0.06, 0.0])
    T0 = np.asarray(jlie.sim3_mul(jlie.sim3_exp(xi), jnp.concatenate(
        [jnp.asarray(T_gt, jnp.float32), jnp.ones(1)])))[:7]
    X32, uv = X.astype(np.float32), uv2.astype(np.float32)
    valid = np.ones((1, len(X)), bool)
    valid[0, ::5] = False
    jT, jc = jpnp.opt_pnp(jnp.asarray(T0)[None], jnp.asarray(X32)[None], jnp.asarray(uv)[None],
                          jnp.asarray(valid), K, iters=25)
    tT, tc = pnp.opt_pnp(t(T0)[None], t(X32)[None], t(uv)[None], t(valid), TK, iters=25)
    np.testing.assert_allclose(n(tT), n(jT), atol=1e-5)
    np.testing.assert_allclose(n(tc), n(jc), atol=1e-5)
    rel = lie.sim3_mul(lie.sim3_inv(torch.cat([tT[0], torch.ones(1)])),
                       torch.cat([t(T_gt, torch.float32), torch.ones(1)]))
    assert float(torch.linalg.vector_norm(lie.sim3_log(rel)[:6])) < 1e-3


def _relative(R6D, t):
    """Camera 2 <- camera 1: rotation and unit translation (gauge-free)."""
    R = n(sixd_to_mtx(torch.as_tensor(n(R6D))))
    Rr = R[1] @ R[0].T
    tr = n(t)[1] - Rr @ n(t)[0]
    return Rr, tr / np.linalg.norm(tr)


@pytest.mark.parametrize("optimize_pts", [False, True])
def test_mini_ba_matches_jax(optimize_pts):
    """``test_poses``' mini-BA case, 40 iterations.  The 6D rotation's
    column scales are a gauge (Gram-Schmidt drops them), and with the
    points free so is the similarity of the whole scene: the two packages
    land on different members of that family (R6D apart by 0.3, points by
    1e-3), so the comparison is gauge-free: the relative rotation and the
    translation's direction within 1e-5 [1.2e-7, 1e-6], and with the
    points fixed the rotations and translations themselves [1e-7, 4e-7]."""
    X, uv1, uv2, R2, t2 = _two_view_scene(n=100)
    rng = np.random.RandomState(1)
    R6D0 = np.stack([np.eye(3)[:, :2], R2[:, :2] + 0.02 * rng.randn(3, 2)]).astype(np.float32)
    t0 = np.stack([np.zeros(3), t2 + [0.05, -0.03, 0.04]]).astype(np.float32)
    X32, uv_obs = X.astype(np.float32), np.stack([uv1, uv2]).astype(np.float32)
    valid = np.ones((2, len(X)), bool)
    jout = jba.mini_ba(jnp.asarray(R6D0), jnp.asarray(t0), jnp.asarray(X32),
                       jnp.asarray(uv_obs), jnp.asarray(valid), jnp.asarray(F), CENTRE,
                       iters=40, optimize_pts=optimize_pts)
    tout = mini_ba.mini_ba(t(R6D0), t(t0), t(X32), t(uv_obs), t(valid), torch.tensor(F), TC,
                           iters=40, optimize_pts=optimize_pts)
    assert float(tout[4]) < 1e-6 and float(jout[4]) < 1e-6
    tR, tt = _relative(tout[0], tout[1])
    jR, jt = _relative(jout[0], jout[1])
    np.testing.assert_allclose(tR, jR, atol=1e-5)
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    np.testing.assert_allclose(tR, R2, atol=1e-5)
    if not optimize_pts:
        np.testing.assert_allclose(n(sixd_to_mtx(tout[0])), n(sixd_to_mtx(t(jout[0]))),
                                   atol=1e-5)
        np.testing.assert_allclose(n(tout[1]), n(jout[1]), atol=1e-5)
        np.testing.assert_array_equal(n(tout[3]), X32)


def _gray_frames(idx, w=512, h=384):
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=w),
                          n_frames=max(idx) + 1, width=w, height=h)
    return [ds[i][0].astype(np.float32).transpose(2, 0, 1) / 255.0 for i in idx]


@pytest.mark.parametrize("image", ["random-64x48", "synthetic-512x384"])
def test_detect_keypoints_matches_jax(image):
    if image == "random-64x48":
        img = np.stack([np.random.RandomState(0).rand(48, 64).astype(np.float32)] * 3)
        num = 256
    else:
        img, num = _gray_frames([0])[0], 1024
    jdk = jfd.FeatureDetector(num_kpts=num)(img)
    tdk = fd.FeatureDetector(num_kpts=num, device=CPU)(img)
    np.testing.assert_array_equal(n(tdk.kpts), n(jdk.kpts))
    np.testing.assert_allclose(n(tdk.scores), n(jdk.scores), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(n(tdk.desc), n(jdk.desc), atol=1e-5)
    zero = n(jdk.scores) == 0
    assert 0 < zero.sum() < num          # the zero-score ties are part of the output
    if image == "synthetic-512x384":
        assert (~zero).sum() == 478
        # lax.top_k's tie order: the first flat indices, the image's first row
        np.testing.assert_array_equal(n(tdk.kpts)[zero][:8, 1], 0)


def test_bootstrap_matches_jax_on_the_synthetic_stream():
    frames = _gray_frames(list(range(9)))
    jp = jpi.PoseInitializer(f=409.6, centre=(256, 192))
    tp = pose_initializer.PoseInitializer(f=409.6, centre=(256, 192), device=CPU)
    assert tp.bootstrap(frames) is jp.bootstrap(frames) is False
    # JAX's counts, stage by stage
    d0, d1 = jp.detect(frames[0]), jp.detect(frames[-1])
    m = jmatch.match_described(d0, d1, min_sim=0.7)
    idx = np.asarray(m.idx)
    _, inl, count = jp.ransac.estimate(np.asarray(d0.kpts)[idx], np.asarray(m.kpts_other))
    inl = np.asarray(inl)
    Rt1 = np.eye(4, dtype=np.float32)
    Rt1[0, 3] = 0.1
    *_, valid = jtri.triangulate(
        jnp.asarray(np.asarray(d0.kpts)[idx][inl]), jnp.asarray(np.asarray(m.kpts_other)[inl])[None],
        jnp.eye(4), jnp.asarray(Rt1)[None], jnp.asarray(409.6), jp.centre, max_error=5e-2,
        min_dis=1e-6)
    jstats = {"matches": len(idx), "inliers": int(count), "triangulated": int(np.sum(valid))}
    assert tp.stats == jstats == {"matches": 689, "inliers": 522, "triangulated": 0}


def _three_view_scene(n_pts=120, dim=64, seed=3):
    """Points seen by three cameras; the second at the bootstrap's guess
    (world -> cam translation (0.1, 0, 0)).  Each view lists its keypoints
    in its own order, with a unit descriptor per point.  Returns the
    describe_fn, the three images (a view's number in its gray level) and
    the third camera's world -> cam 4x4."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1, 1, n_pts),
                  rng.uniform(3, 5, n_pts)], -1)
    desc = rng.randn(n_pts, dim)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    Rt = [np.eye(4) for _ in range(3)]
    Rt[1][0, 3] = 0.1
    R2 = np.asarray(jlie.quat_to_matrix(jlie.sim3_exp(jnp.asarray(
        [0.0, 0.0, 0.0, 0.02, -0.03, 0.01, 0.0]))[3:7]))
    Rt[2][:3, :3], Rt[2][:3, 3] = R2, [0.25, 0.03, -0.05]
    views = []
    for v in range(3):
        Xc = X @ Rt[v][:3, :3].T + Rt[v][:3, 3]
        uv = F * Xc[:, :2] / Xc[:, 2:3] + np.asarray(CENTRE)
        perm = rng.permutation(n_pts)
        views.append((uv[perm].astype(np.float32), desc[perm].astype(np.float32)))
    imgs = [np.full((3, 96, 128), 0.1 * (v + 1), np.float32) for v in range(3)]

    def describe(gray):
        kpts, d = views[int(round(float(gray[0, 0]) * 10)) - 1]
        return kpts, np.ones(len(kpts), np.float32), d

    return describe, imgs, Rt[2].astype(np.float32)


def _pose_error(Rt, Rt_gt):
    rel = lie.sim3_from_matrix(torch.as_tensor(np.linalg.inv(Rt_gt) @ Rt, dtype=torch.float32))
    return float(torch.linalg.vector_norm(lie.sim3_log(rel)[:6]))


def test_register_incremental_keys_points_by_keypoint_index():
    describe, imgs, Rt_gt = _three_view_scene()
    jp = jpi.PoseInitializer(f=F, centre=(64.0, 48.0))
    jp.detector = jfd.FeatureDetector(
        describe_fn=lambda g: tuple(map(jnp.asarray, describe(np.asarray(g)))))
    assert jp.bootstrap([imgs[0], imgs[1]])
    j_err = _pose_error(jp.register_incremental(imgs[2]), Rt_gt)

    tp = pose_initializer.PoseInitializer(f=F, centre=(64.0, 48.0), device=CPU)
    tp.detector = fd.FeatureDetector(
        describe_fn=lambda g: tuple(map(torch.as_tensor, describe(n(g)))), device=CPU)
    assert tp.bootstrap([imgs[0], imgs[1]])
    assert tp.stats == {"matches": 120, "inliers": 120, "triangulated": 120}
    t_err = _pose_error(tp.register_incremental(imgs[2]), Rt_gt)
    assert j_err > 0.1, j_err         # the JAX package's fault (ROADMAP.md section 3)
    assert t_err < 1e-3, t_err
