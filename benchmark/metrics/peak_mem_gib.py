"""Peak device memory allocated over the window, in GiB; in the oracle
cells less the oracle's registered device caches (measured at set-up's
end), which stand in for the model's outputs."""
LAYER = "device"
UNIT = "GiB"
MOVES = "frames_per_s"
SOURCE = "program_counter"
READS = "torch.cuda.max_memory_allocated over the window"


def read(run):
    peak = run.extra.get("memory_window_peak")
    if not peak:
        return None
    return (peak - run.extra.get("oracle_bytes", 0)) / 2 ** 30
