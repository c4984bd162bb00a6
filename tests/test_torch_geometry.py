"""The port's geometry against the JAX package's, on the CPU.

lie, projection, robust and uncertainty: the same numpy inputs through
both, analytic Jacobians included.  Both packages compute in f32 with
elementwise formulas of the same shape, so the tolerance is a few f32
ulps of the values: 1e-6 absolute / 1e-5 relative unless a case says
otherwise.  ``sim3_log`` solves a 3x3 system (LAPACK in both, pivoting
alike), and the large-angle cases carry values of order 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artdeco_tpu.geometry import lie as jlie, projection as jproj, robust as jrobust
from artdeco_tpu.geometry import uncertainty as juncert
from artdeco_tpu_torch.geometry import lie, projection as proj, robust, uncertainty
from torch_parity import CPU, n, t, torch_threads  # noqa: F401

ATOL, RTOL = 1e-6, 1e-5


def close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(n(a), n(b), atol=atol, rtol=rtol)


def rand_sim3(rng, batch, rot=1.0, sig=0.3):
    tr = rng.randn(*batch, 3)
    q = rng.randn(*batch, 4) * np.array([rot, rot, rot, 1.0])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(sig * rng.randn(*batch, 1))
    return np.concatenate([tr, q, s], -1).astype(np.float32)


def both(fn_name, *args, mod=(lie, jlie)):
    """The port's and the JAX package's ``fn_name`` on the same inputs."""
    tmod, jmod = mod
    return (getattr(tmod, fn_name)(*[t(a) for a in args]),
            getattr(jmod, fn_name)(*[jnp.asarray(a) for a in args]))


def test_quaternion_and_so3_ops_match_jax():
    rng = np.random.RandomState(0)
    q1 = rng.randn(9, 4).astype(np.float32)
    q2 = rng.randn(9, 4).astype(np.float32)
    x = rng.randn(9, 3).astype(np.float32)
    close(*both("quat_mul", q1, q2))
    close(*both("quat_inv", q1))
    close(*both("quat_normalize", q1))
    qn = np.asarray(jlie.quat_normalize(jnp.asarray(q1)))
    close(*both("quat_act", qn, x))
    close(*both("quat_to_matrix", qn))
    close(*both("skew", x))
    R = np.asarray(jlie.quat_to_matrix(jnp.asarray(qn)))
    close(*both("matrix_to_quat", R))
    for scale in (0.0, 1e-8, 1e-4, 0.5, 2.5):
        phi = (scale * rng.randn(7, 3)).astype(np.float32)
        a, b = both("so3_exp", phi)
        close(a, b)
        assert torch.isfinite(a).all()
        close(*both("so3_log", np.asarray(b)))


@pytest.mark.parametrize("theta,sigma", [
    (0.0, 0.0), (1e-8, 1e-8), (1e-4, 1e-4), (1e-4, 0.5), (0.5, 1e-8), (0.5, 0.5),
    (2.0, -0.7),
])
def test_sim3_exp_log_match_jax_near_identity_and_large(theta, sigma):
    rng = np.random.RandomState(1)
    phi = rng.randn(6, 3)
    phi = theta * phi / np.linalg.norm(phi, axis=-1, keepdims=True)
    sig = sigma * np.sign(rng.randn(6, 1))
    xi = np.concatenate([rng.randn(6, 3), phi, sig], -1).astype(np.float32)
    a, b = both("sim3_exp", xi)
    assert torch.isfinite(a).all()
    close(a, b)
    la, lb = both("sim3_log", np.asarray(b))
    assert torch.isfinite(la).all()
    close(la, lb, atol=1e-5, rtol=1e-4)
    # the W coefficients of every branch stay finite in the port
    C, A, B = lie._sim3_W_coeffs(t(phi ** 2).sum(-1, keepdim=True), t(sig))
    assert all(torch.isfinite(c).all() for c in (C, A, B))


def test_sim3_group_ops_match_jax():
    rng = np.random.RandomState(2)
    T1, T2 = rand_sim3(rng, (5,)), rand_sim3(rng, (5,))
    X = rng.randn(5, 11, 3).astype(np.float32)
    xi = (0.3 * rng.randn(5, 7)).astype(np.float32)
    close(*both("sim3_inv", T1))
    close(*both("sim3_mul", T1, T2))
    close(*both("sim3_rel", T1, T2))
    close(*both("sim3_normalize", T1 * 1.1))
    close(*both("sim3_act", T1, X))
    close(*both("sim3_act", T1, X[:, 0]))
    (Ya, Ja), (Yb, Jb) = both("sim3_act_jac", T1[:, None], X)
    close(Ya, Yb)
    close(Ja, Jb)
    close(*both("sim3_retr", T1, xi))
    close(*both("sim3_matrix", T1))
    M = np.asarray(jlie.sim3_matrix(jnp.asarray(T1)))
    close(*both("sim3_from_matrix", M), atol=1e-5)
    close(*both("sim3_adj_inv_transpose_apply", T1, xi))
    close(*both("se3_act", T1[:, :7], X))
    close(*both("se3_inv", T1[:, :7]))
    close(*both("se3_mul", T1[:, :7], T2[:, :7]))
    close(*both("se3_matrix", T1[:, :7]))
    close(*both("se3_from_matrix", np.asarray(jlie.se3_matrix(jnp.asarray(T1[:, :7])))))
    close(lie.sim3_identity((2,), device=CPU), jlie.sim3_identity((2,)))
    close(lie.se3_identity(device=CPU), jlie.se3_identity())


def test_sim3_act_jac_is_the_left_perturbation_derivative():
    """The analytic 3x7 Jacobian against central differences of the
    port's own retraction (float64)."""
    rng = np.random.RandomState(3)
    T = t(rand_sim3(rng, (1,))[0]).double()
    X = t(rng.randn(4, 3)).double()
    _, J = lie.sim3_act_jac(T, X)
    eps = 1e-6
    for k in range(7):
        e = torch.zeros(7, dtype=torch.float64)
        e[k] = eps
        num = (lie.sim3_act(lie.sim3_retr(T, e), X)
               - lie.sim3_act(lie.sim3_retr(T, -e), X)) / (2 * eps)
        np.testing.assert_allclose(n(J[..., k]), n(num), atol=1e-6)


def test_projection_matches_jax():
    rng = np.random.RandomState(4)
    K = np.asarray([[300.0, 0, 128.0], [0, 300.0, 96.0], [0, 0, 1.0]], np.float32)
    X = (rng.randn(64, 3) + [0, 0, 3.0]).astype(np.float32)
    X[:4, 2] = -0.5                      # behind the camera
    a, b = both("point_to_ray_dist", X, mod=(proj, jproj))
    close(a, b)
    (ra, Ja), (rb, Jb) = (proj.point_to_ray_dist(t(X), jacobian=True),
                          jproj.point_to_ray_dist(jnp.asarray(X), jacobian=True))
    close(ra, rb)
    close(Ja, Jb)
    uv = rng.uniform(0, 250, (64, 2)).astype(np.float32)
    z = rng.uniform(0.5, 5, (64, 1)).astype(np.float32)
    close(*both("backproject", uv, z, K, mod=(proj, jproj)))
    close(proj.get_pixel_coords((5, 7), device=CPU), jproj.get_pixel_coords((5, 7)))
    Xs = (rng.randn(35, 3) + [0, 0, 3.0]).astype(np.float32)
    close(proj.constrain_points_to_ray((5, 7), t(Xs), t(K)),
          jproj.constrain_points_to_ray((5, 7), jnp.asarray(Xs), jnp.asarray(K)))
    dP_df = rng.randn(64, 3, 1).astype(np.float32)
    for kw in (dict(), dict(border=-10, z_eps=1e-6), dict(border=3, dP_df=dP_df)):
        ta = proj.project_calib(t(X), t(K), (192, 256), jacobian=True,
                                **{k: (t(v) if k == "dP_df" else v) for k, v in kw.items()})
        ja = jproj.project_calib(jnp.asarray(X), jnp.asarray(K), (192, 256), jacobian=True,
                                 **{k: (jnp.asarray(v) if k == "dP_df" else v)
                                    for k, v in kw.items()})
        for x, y in zip(ta, ja):
            close(x, y, atol=1e-5)
        pa, va = proj.project_calib(t(X), t(K), (192, 256), **{k: v for k, v in kw.items()
                                                              if k != "dP_df"})
        close(pa, ta[0])
        np.testing.assert_array_equal(n(va), n(ta[2]))


def test_robust_and_uncertainty_match_jax():
    rng = np.random.RandomState(5)
    r = (3 * rng.randn(50)).astype(np.float32)
    close(*both("huber", r, mod=(robust, jrobust)))
    close(*both("tukey", r, mod=(robust, jrobust)))
    for old, new, d in ((10.0, 9.999, [1e-2] * 7), (10.0, 5.0, [1e-4] * 7),
                        (10.0, 5.0, [1.0] * 7), (0.0, 0.0, [1.0] * 7)):
        a = robust.check_convergence(1e-3, 1e-3, t(np.float32(old)), t(np.float32(new)),
                                     t(np.float32(d)))
        b = jrobust.check_convergence(1e-3, 1e-3, jnp.float32(old), jnp.float32(new),
                                      jnp.asarray(d, jnp.float32))
        assert bool(a) == bool(b)
    H, W = 12, 17
    X = (rng.randn(H * W, 3) + [0, 0, 2.0]).astype(np.float32)
    X[5, 2] = -1.0
    X[9] = np.nan
    valid = rng.rand(H * W) > 0.2
    for win in (3, 5):
        close(uncertainty.local_diag_cov(t(X), H, W, win=win),
              juncert.local_diag_cov(jnp.asarray(X), H, W, win=win))
        close(uncertainty.local_diag_cov(t(X), H, W, win=win, valid=t(valid)),
              juncert.local_diag_cov(jnp.asarray(X), H, W, win=win, valid=jnp.asarray(valid)))
    close(uncertainty.diag_to_cov(t(X[:4])), juncert.diag_to_cov(jnp.asarray(X[:4])))
