"""The model step's share of the card's bf16 peak over the window: the
FLOPs of each window frame's encode and pair decode with heads, counted
analytically from the configuration's widths and the frame size
(``work.mast3r_flops``), over the window's seconds, over 989 TFLOP/s.
Read over the window's head, before the profiled slice: the profiler
slows every launch after it first runs."""
from benchmark import work
from benchmark.reference import mast3r_plain

LAYER = "whole model step"
UNIT = "%"
MOVES = "frame_ms_p90"
SOURCE = "host_clock"
READS = "frames of the window's head times the analytic FLOPs a frame"


def read(run):
    if "model" not in run.config or not run.window.latencies:
        return None
    h, w = run.extra["hw"]
    enc, dec = work.mast3r_flops(mast3r_plain.widths_from(run.config["model"]), h, w)
    frames, seconds = len(run.window.latencies), run.window.seconds
    if run.extra.get("head_s"):
        frames = run.counters["slice_open"]["frames"] - run.counters["open"]["frames"]
        seconds = run.extra["head_s"]
    if frames <= 0:
        return None
    return 100.0 * frames * (enc + dec) / seconds / work.PEAK_BF16_FLOPS
