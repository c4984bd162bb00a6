"""Mean ms of Pi3's encoder a request: the program's ``pi3.encode`` span,
synchronised at both ends in the traced run (the component's
``sync_timing``), over the Pi3 matcher's requests of the window's head (the
whole window where no slice ran).  Here also the helpers the other Pi3
readers share."""
LAYER = "Pi3 encoder"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "program_span"
READS = "the program's pi3.encode spans of the head's requests"


def head_events(run) -> list:
    """The tracer's events of the Pi3 matcher's requests in the window's
    head; [] where the program has no tracer or no such requests."""
    try:
        from artdeco_tpu_torch import trace
    except ImportError:          # a program without the tracer
        return []
    c = run.counters
    if "pi3_calls" not in c.get("open", {}):
        return []
    stop = c["slice_open" if run.extra.get("head_s") else "close"]["pi3_calls"]
    return trace.window("pi3.encode", c["open"]["pi3_calls"], stop)


def per_request(run, name: str, kind: str = "span") -> dict:
    """{request: ms summed over its spans named ``name``}, or with ``kind``
    "count" {request: its counts of ``name`` summed}, over the head."""
    out: dict = {}
    for e in head_events(run):
        if e.kind == kind and e.name == name:
            v = 1e-6 * (e.t1 - e.t0) if kind == "span" else e.n
            out[e.request] = out.get(e.request, 0) + v
    return out


def mean_ms(run, name: str):
    ms = list(per_request(run, name).values())
    return sum(ms) / len(ms) if ms else None


def read(run):
    return mean_ms(run, "pi3.encode")
