"""The Pi3 cell on the CPU: its FLOP count, whole tiny runs that read
``correct`` true when sound, and false with faults planted under the timed
path or with the control in the program's place.

The runs shrink the cell with ``shrink`` below (a tiny Pi3 at 112x140 over
8 keyframes of 64x48, 48 x 64 retrieval features), past the harness's look
for a card, and judge it against the limits here, set for these sizes: the
sound run passes them, each fault and the control fail them.
``on_card_pi3.py`` plants the same faults under a run at the cell's own size,
with its own limits, on the card.  The faults: the global blocks attend
within each frame; the decoder runs without its register tokens; the
decoder's qk-norm is skipped; ``iter_proj`` (under ``match_pi3``) stops after
its head iterations.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch
import torch.nn as nn

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, work_pi3  # noqa: E402
from benchmark.reference import pi3_plain  # noqa: E402
from benchmark.tests import test_benchmark_faults as T  # noqa: E402

CELL = "pi3-vitl-518.reloc24"
SEED = 2 ** 31 + 91
TINY_PI3 = {"patch_size": 14, "enc_embed_dim": 64, "enc_depth": 2, "enc_num_heads": 4,
            "enc_registers": 4, "dec_embed_dim": 64, "dec_depth": 4, "dec_num_heads": 4,
            "dec_registers": 5, "head_dim": 64, "head_depth": 2, "head_num_heads": 4,
            "camera_dim": 32, "mlp_ratio": 4.0, "rope_freq": 100.0, "layerscale_enc": 1.0,
            "layerscale_dec": 0.01}
# a sound run reads about 0.013, 3.7e-4, 7.6e-3, 8.8e-6, 0; the control
# 0.17, 4.4e-3, 0.075, 9.4e-5, 0.098
LIMITS = {"pi3_decoder_err": 0.11, "pi3_points_err": 0.002, "pi3_conf_err": 0.04,
          "pi3_pose_err": 5e-5, "lc_match_diff": 0.01}
FAULTS = ["global_local", "registers_dropped", "qk_norm_skipped", "iter_proj_cut"]


def shrink(config: dict, mix: dict, limits: dict) -> None:
    """The cell at a size a CPU test run holds (the program's tiny Pi3)."""
    mix.update(width=64, height=48, keyframes=8, warmup_frames=1, window_frames_max=40,
               profile_frames=2, profile_at=0.0)
    config["model"] = dict(TINY_PI3)
    config["args"]["model_size"] = "tiny"
    config["resize_hw"] = [112, 140]
    config["retrieval_features"] = [48, 64]


def plant(mp, fault: str, calls: list) -> None:
    """Break the Pi3 query under ``mp`` (a ``pytest.MonkeyPatch``); ``calls``
    records each call of the broken function."""
    from artdeco_tpu_torch.models import pi3 as P

    if fault == "global_local":
        # the odd blocks see each frame as a batch of its own
        orig = P.Pi3.decode

        def broken(self, hidden, B, N, nh, nw, timers):
            calls.append(1)
            return orig(self, hidden, B * N, 1, nh, nw, timers)

        mp.setattr(P.Pi3, "decode", broken)
    elif fault == "registers_dropped":
        # the decoder runs on the patch tokens alone; the heads get zeros
        # where the registers were
        orig = P.Pi3.decode

        def broken(self, hidden, B, N, nh, nw, timers):
            calls.append(1)
            reg = self.register_token
            self.register_token = nn.Parameter(reg[:, :, :0], requires_grad=False)
            try:
                x, pos = orig(self, hidden, B, N, nh, nw, timers)
            finally:
                self.register_token = reg
            r = reg.shape[2]
            return (torch.cat([x.new_zeros(x.shape[0], r, x.shape[2]), x], dim=1),
                    torch.cat([pos.new_zeros(pos.shape[0], r, 2), pos], dim=1))

        mp.setattr(P.Pi3, "decode", broken)
    elif fault == "qk_norm_skipped":
        orig = P.RopeAttention.forward

        def broken(self, x, xpos):
            if not self.qk_norm:
                return orig(self, x, xpos)
            calls.append(1)
            self.qk_norm = False
            try:
                return orig(self, x, xpos)
            finally:
                self.qk_norm = True

        mp.setattr(P.RopeAttention, "forward", broken)
    elif fault == "iter_proj_cut":
        T.plant_model(mp, fault, calls)
    else:
        raise ValueError(fault)


def _run(seconds: float = 2.0, control: bool = False) -> dict:
    def overrides(config, mix, lim):
        shrink(config, mix, lim)
        lim["limits"] = {k: {"limit": v} for k, v in LIMITS.items()}

    torch.set_num_threads(4)
    return harness.run_cell(CELL, SEED, seconds, False, "cpu", time.perf_counter(),
                            overrides=overrides, control=control)


@pytest.mark.parametrize("hwn", [(56, 70, 3), (42, 84, 2)])
def test_pi3_flops_match_flop_counter_on_the_reference(hwn):
    """The analytic count equals ``FlopCounterMode``'s on the plain Pi3,
    whole and for the global blocks (the decoder's odd blocks)."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w, n = hwn
    c = pi3_plain.widths_from(TINY_PI3)
    model = pi3_plain.empty_model(c, "cpu")
    g = torch.Generator().manual_seed(3)
    for prm in model.parameters():
        prm.data.normal_(0.0, 0.02, generator=g)
    imgs = torch.rand(1, n, 3, h, w, generator=g)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(imgs)
    counts = fc.get_flop_counts()
    glob = sum(sum(counts[f"PlainPi3.decoder.{i}"].values())
               for i in range(1, c.dec_depth, 2))
    assert work_pi3.pi3_flops(c, h, w, n) == fc.get_total_flops()
    assert work_pi3.pi3_global_flops(c, h, w, n) == glob


def test_pi3_flops_at_the_published_widths():
    """99.8 TFLOP a 24-frame request at 392x518, 57.3 of it in the global
    blocks (46.0 their attention products)."""
    c = pi3_plain.widths_from(harness.load_config("pi3-vitl-518")["model"])
    total, glob = work_pi3.pi3_flops(c, 392, 518, 24), work_pi3.pi3_global_flops(c, 392, 518, 24)
    assert 99.7e12 < total < 99.9e12 and 57.2e12 < glob < 57.4e12


def test_pi3_sound():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("fault", FAULTS)
def test_pi3_fault(monkeypatch, fault):
    calls = []
    plant(monkeypatch, fault, calls)
    r = _run()
    assert calls and not r["correct"], r["checks"]


def test_pi3_control_is_not_correct():
    r = _run(control=True)
    assert r["control"] and not r["correct"], r["checks"]
