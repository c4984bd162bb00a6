"""Pi3's global blocks' share of the card's bf16 peak while they run: the
analytic FLOPs of the decoder's global blocks (``work_pi3.pi3_global_flops``
at each request's ``pi3.frames``) over the synchronised ``pi3.global``
spans' seconds, summed over the Pi3 matcher's requests of the window's
head, over 989 TFLOP/s: the mechanism's share of its roofline."""
from benchmark import harness, work, work_pi3
from benchmark.reference import pi3_plain

_base = harness.load_metric("pi3_encode_ms")
LAYER = "Pi3 decoder"
UNIT = "%"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "analytic global-block FLOPs over the head's pi3.global span seconds"


def read(run):
    frames = _base.per_request(run, "pi3.frames", "count")
    ms = _base.per_request(run, "pi3.global")
    both = [r for r in ms if r in frames]
    if not both:
        return None
    widths = pi3_plain.widths_from(run.config["model"])
    h, w = run.config["resize_hw"]
    flops = sum(work_pi3.pi3_global_flops(widths, h, w, frames[r]) for r in both)
    seconds = 1e-3 * sum(ms[r] for r in both)
    return 100.0 * flops / seconds / work.PEAK_BF16_FLOPS if seconds > 0 else None
