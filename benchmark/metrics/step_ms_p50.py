"""The median host ms of the model cell's frame, handing a frame over to its
matches on the device, over the frames of the window's head, before the
profiled slice (the profiler slows every launch after it first runs); over
every window frame where no slice ran.  The cell's frames are host-paced
launches whose pace drifts by tens of percent over seconds, so this median
swings between runs too widely for an end-to-end bound: it is read here,
and the cell's end-to-end metric is its tail, ``frame_ms_p90``."""
from benchmark import harness

LAYER = "whole model step"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "host_clock"
READS = "the window's per-frame latencies, the head's frames"


def read(run):
    lat = run.window.latencies
    if "model" not in run.config or not lat:
        return None
    if run.extra.get("head_s"):
        lat = lat[:run.counters["slice_open"]["frames"] - run.counters["open"]["frames"]]
    return harness.percentile([1e3 * x for x in lat], 50) if lat else None
