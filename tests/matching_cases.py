"""Matching inputs shared by the port's matching tests, with no JAX: the
card tests of tests/test_torch_iter_proj.py import them too."""

import numpy as np

from artdeco_tpu_torch.models.oracle import OracleRunner

MATCH_CFG = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-6, dist_thresh=0.1,
                 radius=4, dilation_max=5)


def oracle_pair(h=48, w=64, shift=3):
    """(X11, X21, D11, D21) of two frames of the oracle's plane scene
    ``shift`` stream frames apart (0.02 m each), from the oracle's numpy
    geometry: X21 is frame 2's points in frame 1's camera.  (The port's
    copy, which tests/test_torch_frontend.py holds to the JAX package's.)"""
    K = np.asarray([[0.8 * w, 0, (w - 1) / 2], [0, 0.8 * w, (h - 1) / 2], [0, 0, 1]],
                   np.float32)
    r = OracleRunner((h, w), K, MATCH_CFG, device="cpu")
    for i in (0, shift):
        T = np.asarray([0.02 * i, 0, 0, 0, 0, 0, 1, 1], np.float32)
        r._poses[i] = T
    X11 = r._pointmap(0).reshape(1, h, w, 3)
    # frame `shift`'s world points in frame 0's camera (pose 0 is identity)
    X21 = r._np_sim3_act(r._poses[shift], r._pointmap(shift)).reshape(1, h, w, 3)
    D11 = r._desc(0).reshape(1, h, w, -1)
    D21 = r._desc(shift).reshape(1, h, w, -1)
    return X11, X21, D11, D21
