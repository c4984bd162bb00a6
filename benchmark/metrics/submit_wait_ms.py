"""Mean host ms a frame's main thread is blocked handing work to the
mapper's worker thread (``_MapperWorker.submit``, a queue of depth 4)."""
LAYER = "worker thread"
UNIT = "ms"
MOVES = "frames_per_s"
SOURCE = "host_clock"
READS = "the benchmark's span around submit, 0 on frames without work"


def read(run):
    v = run.spans.get("submit_wait")
    return 1e3 * sum(v) / len(v) if v else None
