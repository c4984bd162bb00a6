"""Small sizes for running the harness on the CPU in tests: the same code
paths as a cell, at sizes a test run holds."""

from __future__ import annotations

TINY_MODEL = {"patch_size": 16, "enc_embed_dim": 64, "enc_depth": 2, "enc_num_heads": 4,
              "dec_embed_dim": 48, "dec_depth": 4, "dec_num_heads": 4, "mlp_ratio": 4.0,
              "rope_freq": 100.0, "local_feat_dim": 24, "dpt_feature_dim": 32,
              "dpt_layer_dims": [16, 24, 32, 48], "conf_vmin": 1.0, "desc_conf_vmin": 0.0}


def shrink(config: dict, mix: dict, limits: dict) -> None:
    """Shrink a cell's configuration and mix in place."""
    mix["warmup_frames"] = min(int(mix["warmup_frames"]), 6)
    mix["window_frames_max"] = 60
    mix["profile_frames"] = 3
    mix["profile_at"] = 0.0
    if config["entry"] == "system_stream":
        mix["width"], mix["height"] = 256, 144
        config["args"]["max_size_slam"] = 64
        config["register_threads"] = 2
        config["mapper"].update(capacity=1 << 13, initial_capacity=1 << 12, new_budget=1 << 10,
                                cluster_capacity=1 << 10, voxel_table_size=1 << 12,
                                vis_budget_init=1 << 12, keyframe_capacity=64)
    else:
        mix["width"], mix["height"] = 96, 64
        config["model"] = dict(TINY_MODEL)
        config["check_frames"] = 3
