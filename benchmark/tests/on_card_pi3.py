"""Read a planted fault in the Pi3 cell at its own size, with its own limits,
on the card:

    python3 benchmark/tests/on_card_pi3.py <cell> <seed> <seconds> <fault>

from the root of a checkout.  ``<fault>`` is one of the faults that
``test_pi3_cell.py`` plants at small sizes on the CPU; the run is a benchmark
run of the cell with the fault planted under the timed path, and prints the
harness's result line, whose ``correct`` has to read false.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import faulthandler  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[2]


def main(argv) -> int:
    cell, seed, seconds, fault = argv[0], int(argv[1]), float(argv[2]), argv[3]
    faulthandler.enable()
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    sys.path.insert(0, str(REPO))

    import pytest
    import torch

    from benchmark import harness
    from benchmark.tests import test_pi3_cell as T

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    if fault not in T.FAULTS:
        harness.log(f"unknown fault {fault!r}")
        return 2
    calls: list = []
    with pytest.MonkeyPatch.context() as mp:
        T.plant(mp, fault, calls)
        result = harness.run_cell(cell, seed, seconds, False, torch.device("cuda", 0), T_START)
    harness.log(f"fault {fault}: the broken function ran {len(calls)} times")
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
