"""Mean host ms of ``Backend.process_sync`` on the frames that made a
keyframe (edge candidates, symmetric matches and the pose-graph GN, on the
tracking thread)."""
LAYER = "backend sync"
UNIT = "ms"
MOVES = "frame_ms_p90"
SOURCE = "host_clock"
READS = "the benchmark's span around process_sync on keyframe frames"


def read(run):
    v = run.spans.get("backend_sync_kf")
    return 1e3 * sum(v) / len(v) if v else None
