"""Mean ms of the tracker's ``trk.match`` timer (``match_asymmetric``:
the matching cascade) a tracked frame over the window; the traced run
synchronises the device at the timer's ends."""
LAYER = "matching cascade"
UNIT = "ms"
MOVES = "frame_ms_p50"
SOURCE = "program_span"
READS = "the program's trk.match timer, window close minus open"


def read(run):
    a, b = run.counters["open"].get("trk_match"), run.counters["close"].get("trk_match")
    if a is None or b is None or b[1] <= a[1]:
        return None
    return 1e3 * (b[0] - a[0]) / (b[1] - a[1])
