"""K3's share of its roofline in the profiled slice: the least time its
rows could take (each row's bytes, ``work.k3_bytes``, over the card's
3.35 TB/s) over the device time of the slice's ``refine_kernel``
launches.  Rows: tracked matches + symmetric rows + pair matches, from the
program's counters at the slice's ends."""
from benchmark import work

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms_p50"
SOURCE = "device_trace"
READS = "refine_kernel device time in the slice; rows from the program's counters"


def read(run):
    t = run.trace
    c0, c1 = run.counters.get("slice_open"), run.counters.get("slice_close")
    if not t or c0 is None or c1 is None:
        return None
    k3_s = sum(s for name, s in t["by_op"].items() if "refine_kernel" in name)
    rows = c1["k3_rows"] - c0["k3_rows"]
    if k3_s <= 0 or rows <= 0:
        return None
    h, w = run.extra.get("slam_hw") or run.extra["hw"]
    bound_s = rows * work.k3_bytes(h, w, int(run.config["descriptor_dim"])) / work.PEAK_BYTES
    return 100.0 * bound_s / k3_s
