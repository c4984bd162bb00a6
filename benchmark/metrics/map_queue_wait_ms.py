"""Mean ms a work item waited in the mapper's queue, from
``_MapperWorker.submit`` to the worker taking it: the program's
``map.queue_wait`` spans of the window's head (the whole window where no
slice ran)."""
LAYER = "worker thread"
UNIT = "ms"
MOVES = "frames_per_s"
SOURCE = "program_span"
READS = "the program's map.queue_wait spans of the head's requests"


def read(run):
    try:
        from artdeco_tpu_torch import trace
    except ImportError:          # a program without the tracer
        return None
    c = run.counters
    stop = c["slice_open" if run.extra.get("head_s") else "close"]["frames"]
    ev = trace.window("frontend.frame", c["open"]["frames"], stop)
    waits = [e.t1 - e.t0 for e in ev if e.name == "map.queue_wait"]
    return 1e-6 * sum(waits) / len(waits) if waits else None
