"""Mean ms of the accurate matcher's match_pi3 of the candidates to the query
and their valid fractions a request: the program's ``lc.match`` span,
synchronised at both ends in the traced run, over the Pi3 matcher's requests
of the window's head (the whole window where no slice ran)."""
from benchmark import harness

_base = harness.load_metric("pi3_encode_ms")
LAYER = "matching cascade"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "the program's lc.match spans of the head's requests"


def read(run):
    return _base.mean_ms(run, "lc.match")
