"""Mean ms of the backend's matching a keyframe: the program's
``bkd.match_asym`` (the keyframe's pair, reused from tracking where it can)
and ``fg.match_sym`` (the symmetric decode and cascade of its candidate
edges) spans, summed over each keyframe request of the window's head (over
the whole window where no slice ran). The traced run synchronises the device
at each span's end."""
LAYER = "backend sync"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "the program's bkd.match_asym and fg.match_sym spans of the head's keyframe requests"


def read(run):
    try:
        from artdeco_tpu_torch import trace
    except ImportError:          # a program without the tracer
        return None
    c = run.counters
    stop = c["slice_open" if run.extra.get("head_s") else "close"]["frames"]
    ev = trace.window("frontend.frame", c["open"]["frames"], stop)
    kf = {e.request for e in ev if e.name == "bkd.match_asym"}
    if not kf:
        return None
    ns = sum(e.t1 - e.t0 for e in ev
             if e.request in kf and e.name in ("bkd.match_asym", "fg.match_sym"))
    return 1e-6 * ns / len(kf)
