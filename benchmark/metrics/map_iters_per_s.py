"""Mapper training iterations completed per second of the window's head,
before the profiled slice (the profiler slows every launch after it first
runs)."""
LAYER = "mapper"
UNIT = "iters/s"
MOVES = "frames_per_s"
SOURCE = "program_counter"
READS = "SceneModel.n_train_steps over the window's head, before the profiled slice"


def read(run):
    a, b = run.counters["open"].get("train_steps"), run.counters["close"].get("train_steps")
    if a is None or b is None:
        return None
    if run.extra.get("head_s"):
        if run.counters["slice_open"]["frames"] == run.counters["open"]["frames"]:
            return None
        return (run.counters["slice_open"]["train_steps"] - a) / run.extra["head_s"]
    return (b - a) / run.window.seconds
