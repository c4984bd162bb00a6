"""Mean host ms a frame spends in ``Frontend.process_frame`` over the window."""
LAYER = "tracking driver"
UNIT = "ms"
MOVES = "frame_ms_p50"
SOURCE = "host_clock"
READS = "the benchmark's span around process_frame, every window frame"


def read(run):
    v = run.spans.get("track")
    return 1e3 * sum(v) / len(v) if v else None
