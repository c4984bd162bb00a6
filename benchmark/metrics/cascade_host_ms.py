"""Mean host ms of one matching cascade (``ops.matching.match``) a call: the
program's ``match.cascade`` span, unsynchronised (the launches and the host
work between them), over the runner's requests of the window's head (the
whole window where no slice ran)."""
LAYER = "matching cascade"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "the program's match.cascade spans of the head's requests"


def read(run):
    try:
        from artdeco_tpu_torch import trace
    except ImportError:          # a program without the tracer
        return None
    c = run.counters
    stop = c["slice_open" if run.extra.get("head_s") else "close"]["frames"]
    ev = trace.window("mast3r.encode", c["open"]["frames"], stop)
    ms = [1e-6 * (e.t1 - e.t0) for e in ev if e.name == "match.cascade"]
    return sum(ms) / len(ms) if ms else None
