"""Faults planted under the timed path, and the controls, turn ``correct``
false.

Each test drives a whole run of a cell on the CPU at a small size
(``tiny.shrink``), past the harness's look for a card, and reads the
result the harness would print: with the program broken underneath
(``plant_oracle``, ``plant_model``), or with the cell's control judged in
the program's place (``run_cell(control=True)``).  The limits here are set
for these small sizes: the sound run passes them (``test_*_sound``), each
fault and each control fails them.  ``on_card.py`` plants the same faults
under a run at a cell's own size, with the cell's own limits, on the card.  The faults a cell can have: a step that returns its state
unchanged, and an answer altered where it is produced.  Batches of one
frame and one chip have no half-batch or inter-chip exchange to leave out.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SEED = 2 ** 31 + 77
# at SLAM 256 a sound oracle run reads a few mm; the bfloat16 control,
# 4 m out, tens of mm
ORACLE_LIMITS = {"lost_frames": 0.0, "frame_rpe_m": 0.012, "keyframe_rpe_m": 0.012}
ORACLE_SECONDS = 10
MODEL_LIMITS = {"tokens_err": 0.2, "pts3d_err": 0.2, "conf_err": 0.2, "desc_err": 0.2,
                "desc_conf_err": 0.2, "cascade_diff": 0.01}
ORACLE_FAULTS = ["tracking_skipped", "keyframe_pose_altered"]
MODEL_FAULTS = ["stale_answer", "point_altered", "iter_proj_cut"]


def plant_oracle(mp, fault: str, calls: list, warm: int) -> None:
    """Break the System under ``mp`` (a ``pytest.MonkeyPatch``); ``calls``
    records each call of the broken function; the first ``warm`` tracked
    frames (the warm-up) stay sound."""
    from artdeco_tpu_torch.vslam import frontend, keyframes

    if fault == "tracking_skipped":
        # each step leaves the state as it was: the frame keeps its initial
        # pose and is neither lost nor a keyframe
        orig = frontend.CameraTracker.track

        def broken(self, frame):
            calls.append(1)
            if len(calls) <= warm:
                return orig(self, frame)
            return frame, False, False, False

        mp.setattr(frontend.CameraTracker, "track", broken)
    elif fault == "keyframe_pose_altered":
        # the odd keyframes' poses moved 5 cm each time the pose-graph GN
        # writes them (an alteration the next solve would otherwise undo)
        orig = keyframes.KeyframeStore.update_T_WCs

        def broken(self, T_WCs, idx):
            calls.append(1)
            T_WCs = np.array(T_WCs, copy=True).reshape(-1, 8)
            T_WCs[np.asarray(idx) % 2 == 1, 0] += 0.05
            return orig(self, T_WCs, idx)

        mp.setattr(keyframes.KeyframeStore, "update_T_WCs", broken)
    else:
        raise ValueError(fault)


def plant_model(mp, fault: str, calls: list) -> None:
    """Break the MASt3R step under ``mp``."""
    from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner
    from artdeco_tpu_torch.ops import matching

    if fault == "stale_answer":
        # every call returns the first call's answer: the state never moves
        orig = Mast3rRunner.match_asymmetric
        first = {}

        def broken(self, *a, **k):
            calls.append(1)
            if "out" not in first:
                first["out"] = orig(self, *a, **k)
            return first["out"]

        mp.setattr(Mast3rRunner, "match_asymmetric", broken)
    elif fault == "point_altered":
        orig = Mast3rRunner.decode

        def broken(self, *a, **k):
            calls.append(1)
            r1, r2 = orig(self, *a, **k)
            r1["pts3d"] = r1["pts3d"].clone()
            r1["pts3d"][0, 5, 7] *= -1.0          # one pixel's point mirrored
            return r1, r2

        mp.setattr(Mast3rRunner, "decode", broken)
    elif fault == "iter_proj_cut":
        # iter_proj stops after its head iterations: the tail that the
        # unconverged pixels need is skipped
        orig = matching.iter_proj

        def broken(*a, **k):
            calls.append(1)
            k["max_iter"] = matching.HEAD_ITERS
            return orig(*a, **k)

        mp.setattr(matching, "iter_proj", broken)
    else:
        raise ValueError(fault)


def _run(cell: str, limits: dict, seconds: float, control: bool = False) -> dict:
    def overrides(config, mix, lim):
        tiny.shrink(config, mix, lim)
        if config["entry"] == "system_stream":
            # two pixels a frame at SLAM 256 (a pixel is 1 cm on the plane)
            # and a lower keyframe threshold: frames between keyframes, whose
            # poses the pose-graph GN does not revisit
            mix["width"], mix["height"], mix["step_m"] = 512, 288, 0.02
            config["args"]["max_size_slam"] = 256
            config["system"]["tracking"]["match_frac_thresh"] = 0.8
        lim["limits"] = {k: {"limit": v} for k, v in limits.items()}

    torch.set_num_threads(4)
    return harness.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter(),
                            overrides=overrides, control=control)


# -- the oracle System ---------------------------------------------------------------

def test_oracle_sound():
    r = _run("oracle-base.dense", ORACLE_LIMITS, ORACLE_SECONDS)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ORACLE_FAULTS)
def test_oracle_fault(monkeypatch, fault):
    calls = []
    plant_oracle(monkeypatch, fault, calls, warm=6)
    r = _run("oracle-base.dense", ORACLE_LIMITS, ORACLE_SECONDS)
    assert calls and not r["correct"], r["checks"]


def test_oracle_control_is_not_correct():
    r = _run("oracle-base.dense", ORACLE_LIMITS, ORACLE_SECONDS, control=True)
    assert r["control"] and not r["correct"], r["checks"]


# -- the MASt3R step --------------------------------------------------------------

def test_model_sound():
    r = _run("mast3r-vitl-512.track", MODEL_LIMITS, 3)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", MODEL_FAULTS)
def test_model_fault(monkeypatch, fault):
    calls = []
    plant_model(monkeypatch, fault, calls)
    r = _run("mast3r-vitl-512.track", MODEL_LIMITS, 3)
    assert calls and not r["correct"], r["checks"]


def test_model_control_is_not_correct():
    r = _run("mast3r-vitl-512.track", MODEL_LIMITS, 3, control=True)
    assert r["control"] and not r["correct"], r["checks"]
