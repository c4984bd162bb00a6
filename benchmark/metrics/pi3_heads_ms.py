"""Mean ms of Pi3's point, confidence and camera heads, with the SVD and the
unprojection a request: the program's ``pi3.heads`` span, synchronised at
both ends in the traced run, over the Pi3 matcher's requests of the window's
head (the whole window where no slice ran)."""
from benchmark import harness

_base = harness.load_metric("pi3_encode_ms")
LAYER = "Pi3 heads"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "the program's pi3.heads spans of the head's requests"


def read(run):
    return _base.mean_ms(run, "pi3.heads")
