"""The benchmark's harness: finds a cell's files by name, runs it, reports.

Everything particular to one configuration, traffic mix, cell or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the configuration as it is run; its
  ``entry`` names the driver.
- ``traffic/<mix>.json``: the mix's parameters for ``traffic/stream.py``.
- ``drivers/<entry>.py``: one driver per entry point of the program.
- ``metrics/<metric>.py``: one reader per per-layer metric.
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares, with the readings it was set from.

A driver is a class ``Driver(config, mix, seed, device, tracer)`` that
does the set-up and warm-up in its constructor and has
``run_window(seconds) -> Window``, ``finish()`` (after the window: drain,
synchronise), ``release()`` (free the program's state) and
``check(control) -> {name: value}`` (the numbers judged against the
limits; with ``control`` true, those of the cell's control: the plain
reference in the precision below the configuration's, put in the
program's place).  A reader is a
module with ``LAYER``, ``UNIT``, ``MOVES``, ``SOURCE`` and ``read(run) ->
float | None``; it returns None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "artdeco_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------

def load_spec(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_traffic(name: str) -> dict:
    return _json("traffic", name)


def load_limits(cell: str) -> dict:
    return _json("limits", cell)


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(entry: str):
    return _module("drivers", entry).Driver


def load_metric(name: str):
    return _module("metrics", name)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have: {', '.join(c['name'] for c in spec['workloads'])})")


def metrics_of(spec: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Window:
    """What a driver's window produced, on the host clock."""
    seconds: float                 # the window's length
    latencies: list                # seconds per frame whose result returned inside it
    attempted: int                 # frames handed to the program inside the window
    failed: int                    # frames that failed (lost), plus 1 if the stream ran out
    exhausted: bool = False


def end_to_end(win: Window, setup_s: float) -> dict:
    """The end-to-end metrics by name: all from the host clock."""
    ms = [1e3 * x for x in win.latencies]
    return {
        "frames_per_s": (len(win.latencies) / win.seconds, "frames/s"),
        "frame_ms_p50": (percentile(ms, 50), "ms"),
        "frame_ms_p90": (percentile(ms, 90), "ms"),
        "setup_s": (setup_s, "s"),
    }


# ---------------------------------------------------------------------------
# Tracing: host spans over the window, a profiled slice of it
# ---------------------------------------------------------------------------

class Tracer:
    """Host spans (always recorded, reported in the traced run), program
    counters at the window's ends and at the profiled slice's ends, and
    (when ``on``) ``torch.profiler`` over ``profile_frames`` frames that
    start once ``profile_at`` of the window has passed.  The trace stays in
    memory; ``trace_summary`` reduces it.  Once the profiler has run, the
    process launches kernels more slowly (CUPTI stays attached), so rates
    are read over the window's head, before the slice (``head_s``)."""

    def __init__(self, on: bool, profile_at: float = 0.3, profile_frames: int = 8):
        self.on = on
        self.profile_at = profile_at
        self.profile_frames = profile_frames
        self.spans: dict = {}
        self.counters: dict = {}
        self.prof = None
        self.slice_s = None
        self.head_s = None
        self._left = 0
        self._done = False
        self._t0 = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def annotate(self, name: str):
        """A profiler range around a host phase (free when not profiling)."""
        import contextlib

        import torch

        return (torch.profiler.record_function(name) if self.prof is not None
                else contextlib.nullcontext())

    def open(self, t_open: float, seconds: float, counters: dict) -> None:
        self.t_open, self.seconds = t_open, seconds
        self.counters["open"] = counters

    def before_frame(self, now: float, counters_fn, device, quiesce=None) -> None:
        """Start the profiled slice when its time has come; ``quiesce``
        waits until no other thread of the program runs, so the profiler
        is never switched on under a running operator."""
        if (self.on and self.prof is None and not self._done
                and now - self.t_open >= self.profile_at * self.seconds):
            if quiesce is not None:
                quiesce()
            sync(device)
            self.counters["slice_open"] = counters_fn()
            self.head_s = time.perf_counter() - self.t_open
            self.prof = _new_profiler(device)
            self.prof.start()
            self._t0 = time.perf_counter()
            self._left = self.profile_frames

    def after_frame(self, counters_fn, device, quiesce=None) -> None:
        if self.prof is not None and not self._done:
            self._left -= 1
            if self._left <= 0:
                self._stop(counters_fn, device, quiesce)

    def _stop(self, counters_fn, device, quiesce=None) -> None:
        if quiesce is not None:
            quiesce()
        sync(device)
        self.slice_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.counters["slice_close"] = counters_fn()
        self.counters["slice_frames"] = self.profile_frames - self._left
        self._done = True

    def close(self, counters: dict, counters_fn, device, quiesce=None) -> None:
        if self.prof is not None and not self._done:
            self._stop(counters_fn, device, quiesce)
        self.counters["close"] = counters


def _new_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def _union_s(intervals) -> float:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_summary(prof, slice_s: float) -> dict:
    """From a finished profile: the device's busy seconds (the union of
    every kernel, copy and fill; ranges that ``record_function`` projects
    onto the device timeline are not device work), the device time by
    operation name, the idle gaps between device work named by the
    benchmark's host range (``bench:*``) open at the gap's start, the
    device seconds and count of each ``bench:*`` range (the kernels of the
    operators called inside it), and the slice's length.  None when the
    trace holds no device activity."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((t0, t1, e.name()))
        elif e.name().startswith("bench:"):
            host.append((t0, t1, e.name()[len("bench:"):]))
    if not dev:
        return None
    ranges: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("bench:"):
            r = ranges.setdefault(e.name[len("bench:"):], [0.0, 0])
            r[0] += e.device_time_total * 1e-6
            r[1] += 1
    by_op: dict = {}
    for t0, t1, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (t1 - t0) * 1e-9
    busy = _union_s([(a, b) for a, b, _ in dev]) * 1e-9
    gaps: dict = {}
    end = None
    for a, b, _ in sorted(dev):
        if end is not None and a > end:
            hit = [h for h in host if h[0] <= end < h[1]]
            what = min(hit, key=lambda h: h[1] - h[0])[2] if hit else "between frames"
            gaps[what] = gaps.get(what, 0.0) + (a - end) * 1e-9
        end = b if end is None else max(end, b)
    return {"busy_s": busy, "window_s": slice_s, "by_op": by_op, "gaps": gaps,
            "ranges": ranges}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """Everything a per-layer reader may read."""
    cell: dict
    config: dict
    mix: dict
    window: Window
    spans: dict
    counters: dict
    trace: dict              # trace_summary(...) or None
    extra: dict              # what the driver adds (sizes, memory, ...)


def card_power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, spec: dict = None, overrides=None,
             control: bool = False) -> dict:
    """One run of a cell: set-up, warm-up, the window, the check.  Returns
    the result object (without printing).  ``overrides(config, mix,
    limits)``, for tests, may shrink the sizes; ``t_start`` is the
    process's start on the host clock (``time.perf_counter``).  With
    ``control``, the check judges the cell's control in the program's
    place against the same limits, so ``correct`` has to read false."""
    import torch

    spec = spec or load_spec()
    cell = find_cell(spec, cell_name)
    config = load_config(cell["config"])
    mix = load_traffic(cell["traffic"])
    limits = load_limits(cell_name)
    if overrides is not None:
        overrides(config, mix, limits)
    device = torch.device(device)
    tracer = Tracer(trace, float(mix.get("profile_at", 0.3)), int(mix.get("profile_frames", 8)))
    Driver = load_driver(config["entry"])
    t_driver = time.perf_counter()
    drv = Driver(config, mix, seed, device, tracer)
    drv.setup_split = {"start": t_driver - t_start, **drv.setup_split}
    # set-up's objects out of the collector's way: a full collection over
    # them would land, at random, inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    win = drv.run_window(float(seconds))
    drv.finish()
    extra = dict(drv.extra, head_s=tracer.head_s)
    peak = extra.get("memory_peak_bytes", 0)
    trace_sum = (trace_summary(tracer.prof, tracer.slice_s)
                 if tracer.prof is not None and tracer.slice_s else None)
    tracer.prof = None
    drv.release()
    if control:
        log("control run: the cell's control stands in the program's place in the check")
    numbers = drv.check(control)
    checks = {}
    correct = True
    for name, value in numbers.items():
        if name not in limits["limits"]:
            log(f"reading {name}: {value!r} (not compared: see the limits file)")
            continue
        lim = limits["limits"][name]["limit"]
        ok = value is not None and math.isfinite(value) and value <= lim
        correct &= ok
        checks[name] = {"value": value, "limit": lim}
    if win.exhausted:
        log(f"stream exhausted: the mix's {mix['window_frames_max']} window frames ran out "
            "before the window closed; the rest of the window counts as failed (raise "
            "window_frames_max in a benchmark change)")
    log(f"set-up split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in drv.setup_split.items()))
    result = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed}
    if control:
        result["control"] = True
    run = Run(cell, config, mix, win, tracer.spans, tracer.counters, trace_sum, extra)
    metrics = {}
    if not trace:
        e2e = end_to_end(win, setup_s)
        for m in metrics_of(spec, cell_name, "end_to_end"):
            value, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        for m in metrics_of(spec, cell_name, "per_layer"):
            value = load_metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit": card_power_limit() if device.type == "cuda" else "none"}
    if trace and trace_sum is not None:
        dev["busy_s"] = trace_sum["busy_s"]
        dev["window_s"] = trace_sum["window_s"]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(trace_sum["by_op"].items(),
                                                     key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(trace_sum["gaps"].items(),
                                                    key=lambda kv: -kv[1])[:10]]}
    result["device"] = dev
    result["setup_split"] = drv.setup_split
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """The checks on stderr as its last lines, then the result on stdout."""
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
