"""The model cell's frame rate: frames finished over the window's head,
before the profiled slice, over its seconds (over the whole window where no
slice ran).  In the oracle cells the rate is the end-to-end
``frames_per_s``; the model cell's host-paced launches drift in pace
between runs too widely for an end-to-end bound, so it is read here."""
LAYER = "whole model step"
UNIT = "frames/s"
MOVES = "frame_ms_p90"
SOURCE = "host_clock"
READS = "frames finished in the window's head over its seconds"


def read(run):
    if "model" not in run.config or not run.window.latencies:
        return None
    frames, seconds = len(run.window.latencies), run.window.seconds
    if run.extra.get("head_s"):
        frames = run.counters["slice_open"]["frames"] - run.counters["open"]["frames"]
        seconds = run.extra["head_s"]
    return frames / seconds if frames > 0 else None
