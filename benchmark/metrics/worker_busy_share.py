"""Share of the window's head the mapper's worker thread spent on work items:
the program's ``map.item`` spans of the head's requests, clipped to the
head's frames (from the first ``frontend.frame`` span's start to the end of
the last frame's ``frontend.frame`` or ``backend.sync`` span), over that
length; over the whole window where no slice ran. The worker's drain before
the slice (or at the window's close), while the tracking thread hands it
nothing, lies after that end and is left out."""
LAYER = "worker thread"
UNIT = "%"
MOVES = "frames_per_s"
SOURCE = "program_span"
READS = "the program's map.item spans of the head's requests inside the head's frames"


def read(run):
    try:
        from artdeco_tpu_torch import trace
    except ImportError:          # a program without the tracer
        return None
    c = run.counters
    stop = c["slice_open" if run.extra.get("head_s") else "close"]["frames"]
    ev = trace.window("frontend.frame", c["open"]["frames"], stop)
    frames = [e for e in ev if e.name == "frontend.frame"]
    if not frames:
        return None
    t0 = min(e.t0 for e in frames)
    t1 = max(e.t1 for e in ev if e.name in ("frontend.frame", "backend.sync"))
    busy = sum(max(0, min(e.t1, t1) - max(e.t0, t0)) for e in ev if e.name == "map.item")
    return 100.0 * busy / (t1 - t0)
