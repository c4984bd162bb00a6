"""Mean ms of the factor graph's ``gn.solve`` timer a solve over the
window; the traced run synchronises the device at the timer's ends."""
LAYER = "pose-graph GN"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "the program's gn.solve timer, window close minus open"


def read(run):
    a, b = run.counters["open"].get("gn_solve"), run.counters["close"].get("gn_solve")
    if a is None or b is None or b[1] <= a[1]:
        return None
    return 1e3 * (b[0] - a[0]) / (b[1] - a[1])
