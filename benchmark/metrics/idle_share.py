"""Share of the profiled slice in which no operation ran on the device."""
LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"
SOURCE = "device_trace"
READS = "the union of device kernels, copies and fills over the slice's host time"


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
