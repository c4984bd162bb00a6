"""The keypoint-SfM pose bootstrap: detection, mutual-NN matching, RANSAC,
triangulation, PnP, mini bundle adjustment and guided multi-view depth.

Port of ``artdeco_tpu/poses/`` (the legacy on-the-fly-NVS initialisation
path; the main pipeline initialises with the MASt3R tracker instead).
"""

from artdeco_tpu_torch.poses import (  # noqa: F401
    feature_detector, guided_mvs, matcher, mini_ba, pnp, pose_initializer, ransac,
    triangulator,
)
