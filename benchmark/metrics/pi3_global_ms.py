"""Mean ms of Pi3's global blocks a request: the program's ``pi3.global``
spans (one a global block, synchronised at both ends in the traced run)
summed over each of the Pi3 matcher's requests of the window's head."""
from benchmark import harness

_base = harness.load_metric("pi3_encode_ms")
LAYER = "Pi3 decoder"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "the program's pi3.global spans of the head's requests, summed a request"


def read(run):
    return _base.mean_ms(run, "pi3.global")
