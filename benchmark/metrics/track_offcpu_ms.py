"""Mean ms a frame's tracking thread did not run inside
``Frontend.process_frame``: the program's ``frontend.frame`` root span, its
wall time less its thread CPU time, over the window's head (the whole window
where no slice ran). Time waiting for the interpreter lock or blocked in a
call counts; a device synchronisation that spins does not."""
LAYER = "tracking driver"
UNIT = "ms"
MOVES = "frame_ms_p50"
SOURCE = "program_span"
READS = "the program's frontend.frame spans of the head, wall minus thread CPU"


def read(run):
    try:
        from artdeco_tpu_torch import trace
    except ImportError:          # a program without the tracer
        return None
    c = run.counters
    stop = c["slice_open" if run.extra.get("head_s") else "close"]["frames"]
    ev = trace.window("frontend.frame", c["open"]["frames"], stop)
    off = [e.t1 - e.t0 - e.cpu_ns for e in ev
           if e.name == "frontend.frame" and e.cpu_ns is not None]
    return 1e-6 * sum(off) / len(off) if off else None
