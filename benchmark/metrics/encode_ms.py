"""Device ms of one MASt3R encode (``Mast3rRunner.encode_image``) in the
profiled slice: the profiler's time of the kernels launched inside it."""
LAYER = "MASt3R encoder"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "device_trace"
READS = "device time under the benchmark's bench:encode range, per call"


def read(run):
    r = (run.trace or {}).get("ranges", {}).get("encode")
    if not r or r[1] == 0 or r[0] <= 0:
        return None
    return r[0] / r[1] * 1e3
