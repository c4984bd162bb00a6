"""Run one cell of the benchmark once, on the CUDA device this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
                             [--control 1]

From the root of a checkout.  Makes the cell's inputs from ``--seed``, sets
up and warms up the program (``artdeco_tpu_torch``), measures for
``--seconds``, checks the outputs against the plain references in
``benchmark/reference/``, and prints one JSON line on stdout: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and a breakdown of the profiled slice.  The numbers the
check compares, each with its limit, are the last lines on stderr and the
result's last key.  ``--control 1`` runs the same, then judges the cell's
control (the plain reference in the precision below the configuration's)
in the program's place against the same limits: ``correct`` reads false
there, and the program's own numbers are logged as readings.  The
benchmark's own runs never pass it.

Exits non-zero without a result when no CUDA device is present, when the
cell asks for more devices than there are, or when JAX, jaxlib, flax or
the JAX package (``artdeco_tpu``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    faulthandler.enable()     # a crash prints every thread's stack

    # every kernel cache inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    sys.path.insert(0, str(REPO))

    from benchmark import harness

    import torch

    spec = harness.load_spec()
    cell = harness.find_cell(spec, a.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark measures the program on the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{a.workload} needs {cell['chips']} CUDA devices, "
                    f"{torch.cuda.device_count()} present")
        return 2
    result = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                              torch.device("cuda", 0), T_START, spec=spec,
                              control=bool(a.control))
    found = harness.forbidden_modules()
    if found:
        harness.log(f"forbidden modules loaded in the benchmark's process: {', '.join(found)}")
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
