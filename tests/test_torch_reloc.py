"""Relocalization in the port's ``System`` against the JAX package's, on the CPU.

``tests/test_reloc.py``'s teleport stream and stub retrieval (copied here;
the JAX test stays as it is): the camera walks 3.25 units along x, beyond
any view overlap, then teleports back near the origin.  The teleport frame
is lost; the backend relocalizes on a retrieval hit on the first keyframe
(append, strict two-way match, the retrieved pose, a GN solve) and the
frames after it track against the new keyframe.  Both packages run the
same stream: the same lost count and keyframe frames, keyframe poses and
the frame trajectory within 1e-4.
"""

import os
import types

import numpy as np

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.models.oracle import OracleRunner as JOracleRunner
from artdeco_tpu.runtime.system import System as JSystem
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.runtime.system import System
from artdeco_tpu_torch.utils.config import load_config
from test_torch_backend import register
from torch_parity import CPU, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "config", "base.yaml")


def teleport(base):
    class TeleportDataset(base):
        """Walk 0 -> 3.25 in x, then teleport back near the origin."""

        N_WALK = 14
        N_TOTAL = 20
        STEP = 0.25

        def __init__(self, args, width=160, height=120):
            super().__init__(args, n_frames=self.N_TOTAL, width=width, height=height)
            poses = np.zeros((self.N_TOTAL, 7))
            poses[:, 6] = 1.0
            for i in range(self.N_TOTAL):
                poses[i, 0] = (self.STEP * i if i < self.N_WALK
                               else 0.05 + 0.02 * (i - self.N_WALK))
            self.Twc_gt = poses
    return TeleportDataset


class StubRetrieval:
    """Pose-aware retrieval stand-in: the stored keyframes whose ground-truth
    x lies within ``overlap_x`` of the query frame's (the oracle's token
    carries the frame id)."""

    def __init__(self, dataset, keyframes, overlap_x=1.0):
        self.dataset = dataset
        self.keyframes = keyframes
        self.overlap_x = overlap_x
        self._stored: list = []

    def update(self, feat, add_after_query=True, k=3, min_thresh=0.0):
        fid = int(np.asarray(feat)[0, 0])
        x_q = self.dataset.Twc_gt[fid][0]
        hits = [kf_i for kf_i, f in self._stored
                if abs(self.dataset.Twc_gt[f][0] - x_q) < self.overlap_x]
        if add_after_query:
            self._stored.append((len(self.keyframes) - 1 if len(self.keyframes) else 0, fid))
        return hits[:k]


def _reloc_run(ds_cls, cfg_load, runner_cls, system_cls, mcfg_cls, **dev):
    args = types.SimpleNamespace(
        source_path="", images_dir="images", downsampling=2.0, max_size_slam=128,
        start_at=0, end_at=0, seq_length=0, image_sampling=0, dataset_name="synthetic",
        test_hold=-1, calib=None, init_focal=-1.0, init_fov=-1.0, optimize_focal=False,
        covariance_filter=False, point_fusion_frontend=True, use_all_frames=False,
        use_same_set_of_keyframes=False, min_displacement=0.03, thres_keyframe=0.8,
        num_GBA=1, num_key_iterations=2, num_common_iterations=1, sh_degree=1,
        local_feat_dim=8, global_feat_dim=8, pyr_levels=1)
    ds = teleport(ds_cls)(args)
    cfg = cfg_load(CFG)
    cfg["matching"].update(radius=1, dilation_max=1, dist_thresh=0.05)
    cfg["tracking"]["match_frac_thresh"] = 0.95
    runner = runner_cls((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], **dev)
    register(runner, ds)
    mcfg = mcfg_cls(capacity=4096, cluster_capacity=1024, voxel_table_size=4096,
                    new_budget=1024, keyframe_capacity=64, sh_degree=1, local_feat_dim=8,
                    global_feat_dim=8, pyr_levels=1, gs_add_ratio=1.0, init_proba_scaler=4.0)
    sys_ = system_cls(args, cfg, ds, runner, mapper_cfg=mcfg, retrieval="placeholder", **dev)
    sys_.backend.retrieval = StubRetrieval(ds, sys_.keyframes)
    sys_.run(progress=False)
    return sys_, ds


def test_relocalization_matches_jax():
    tsys, ds = _reloc_run(SyntheticDataset, load_config, OracleRunner, System, MapperConfig,
                          device=CPU)
    jsys, _ = _reloc_run(JSyntheticDataset, jload_config, JOracleRunner, JSystem,
                         JMapperConfig)
    n_walk = 14
    assert 1 <= tsys.frontend.lost_number <= 2
    assert tsys.frontend.lost_number == jsys.frontend.lost_number
    n_kf = len(tsys.keyframes)
    fids = tsys.keyframes.dataset_idx[:n_kf].tolist()
    assert fids == jsys.keyframes.dataset_idx[:len(jsys.keyframes)].tolist()
    post = [i for i, f in enumerate(fids) if f >= n_walk]
    assert post, f"no post-teleport keyframe (fids={fids})"
    for i in post:
        err = np.abs(tsys.keyframes.T_WC[i][:3] - ds.Twc_gt[fids[i]][:3]).max()
        assert err < 0.15, (i, err)
    np.testing.assert_allclose(tsys.keyframes.T_WC[:n_kf], jsys.keyframes.T_WC[:n_kf],
                               atol=1e-4)
    est, jest = tsys.frontend.estimated_trajectory(), jsys.frontend.estimated_trajectory()
    assert est.shape == jest.shape
    np.testing.assert_allclose(est, jest, atol=1e-4)
    post_rows = [r for r in est if int(r[0]) > n_walk]
    assert post_rows
    for r in post_rows:
        assert abs(r[1] - ds.Twc_gt[int(r[0])][0]) < 0.2
