"""Tracking's LM iterations a tracked frame over the window's head (the whole
window where no slice ran): the program's ``trk.lm_iters`` counter, one host
round trip an iteration, over the requests with a ``trk.match`` span."""
LAYER = "tracking LM"
UNIT = "iters/frame"
MOVES = "frame_ms_p50"
SOURCE = "program_counter"
READS = "the program's trk.lm_iters counts of the head's tracked frames"


def read(run):
    try:
        from artdeco_tpu_torch import trace
    except ImportError:          # a program without the tracer
        return None
    c = run.counters
    stop = c["slice_open" if run.extra.get("head_s") else "close"]["frames"]
    ev = trace.window("frontend.frame", c["open"]["frames"], stop)
    tracked = {e.request for e in ev if e.name == "trk.match"}
    if not tracked:
        return None
    return sum(e.n for e in ev if e.name == "trk.lm_iters" and e.request in tracked) / len(tracked)
