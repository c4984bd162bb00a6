"""The median host ms of the relocalization query, handing it over to
``update``'s return, over the requests of the window's head, before the
profiled slice (the profiler slows every launch after it first runs); over
every window request where no slice ran."""
from benchmark import harness

LAYER = "relocalization query"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "host_clock"
READS = "the window's per-request latencies, the head's requests"


def read(run):
    lat = run.window.latencies
    c = run.counters
    if "pi3_calls" not in c.get("open", {}) or not lat:
        return None
    if run.extra.get("head_s"):
        lat = lat[:c["slice_open"]["frames"] - c["open"]["frames"]]
    return harness.percentile([1e3 * x for x in lat], 50) if lat else None
