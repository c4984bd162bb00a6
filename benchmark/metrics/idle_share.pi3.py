"""``idle_share``, read in the Pi3 cell, whose end-to-end metric besides set-up
is the request tail, ``frame_ms_p90``."""
from benchmark import harness

_base = harness.load_metric("idle_share")
LAYER = _base.LAYER
UNIT = _base.UNIT
MOVES = "frame_ms_p90"
SOURCE = _base.SOURCE
READS = _base.READS
read = _base.read
