"""Device ms of one MASt3R pair decode with both heads
(``Mast3rRunner.decode``) in the profiled slice."""
LAYER = "MASt3R decoders and heads"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "device_trace"
READS = "device time under the benchmark's bench:decode range, per call"


def read(run):
    r = (run.trace or {}).get("ranges", {}).get("decode")
    if not r or r[1] == 0 or r[0] <= 0:
        return None
    return r[0] / r[1] * 1e3
