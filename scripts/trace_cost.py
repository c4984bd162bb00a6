"""What the port's tracer (``artdeco_tpu_torch/trace.py``) costs on this host.

    python scripts/trace_cost.py [--n 200000]

Times ``n`` empty spans in a loop, less the same loop around an empty
context manager: a plain span, one opened through a component's ``Timers``,
a request's root span (which also reads the thread's CPU time) and a count.
Then the same with ``torch.profiler`` recording (CPU and, where there is a
card, CUDA activities), where each span is also a ``record_function`` range.
Prints one JSON line: ns per span enter and exit, by case, with the
device's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from artdeco_tpu_torch import trace  # noqa: E402


def per_call_ns(fn, base, n: int) -> float:
    """ns per ``fn(i)`` less ``base(i)``, each the fastest of 3 loops of n."""
    def loop(f):
        t0 = time.perf_counter_ns()
        for i in range(n):
            f(i)
        return time.perf_counter_ns() - t0

    return (min(loop(fn) for _ in range(3)) - min(loop(base) for _ in range(3))) / n


def enter_exit(cm) -> None:
    with cm:
        pass


def cases(n: int) -> dict:
    timers = trace.Timers()
    null = contextlib.nullcontext()
    empty = lambda i: enter_exit(null)      # noqa: E731
    return {
        "span": per_call_ns(lambda i: enter_exit(trace.span("cost.span")), empty, n),
        "timers_span": per_call_ns(lambda i: enter_exit(timers.span("cost.timers")), empty, n),
        "root_span": per_call_ns(
            lambda i: enter_exit(trace.span("cost.root", request=(0, i))), empty, n),
        "count": per_call_ns(lambda i: trace.count("cost.count"), lambda i: None, n),
    }


def device_label() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return torch.cuda.get_device_name(0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    a = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile

    off = cases(a.n)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on = cases(a.n // 10)
    print(json.dumps({"device": device_label(), "torch": torch.__version__,
                      "python": sys.version.split()[0], "n": a.n,
                      "ns_profiler_off": off, "ns_profiler_on": on}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
