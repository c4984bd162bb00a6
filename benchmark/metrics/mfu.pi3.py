"""The relocalization query's share of the card's bf16 peak: the FLOPs of
every Pi3 run of the window's head, counted from the configuration's
widths, its resolution and each run's frames (the program's ``pi3.frames``
counter, padding included; ``work_pi3.pi3_flops``), over the head's
seconds, over 989 TFLOP/s.  The head's seconds hold the whole request:
ASMK on the host, the resize, Pi3 and the matching."""
from benchmark import harness, work, work_pi3
from benchmark.reference import pi3_plain

_base = harness.load_metric("pi3_encode_ms")
LAYER = "relocalization query"
UNIT = "%"
MOVES = "frame_ms_p90"
SOURCE = "host_clock"
READS = "the head's pi3.frames counts times the analytic FLOPs, over the head's seconds"


def read(run):
    frames = _base.per_request(run, "pi3.frames", "count")
    seconds = run.extra.get("head_s") or run.window.seconds
    if not frames or not seconds:
        return None
    widths = pi3_plain.widths_from(run.config["model"])
    h, w = run.config["resize_hw"]
    flops = sum(work_pi3.pi3_flops(widths, h, w, n) for n in frames.values())
    return 100.0 * flops / seconds / work.PEAK_BF16_FLOPS
