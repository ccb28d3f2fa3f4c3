"""Shared set-up of the benchmark's CPU tests: the paths, and one run of a
fixture cell (``tests/fixtures``: the port's smoke configurations at
float32, tiny traffic) through the whole harness on the CPU."""
from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FIXTURES = BENCH / "tests" / "fixtures"

for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def cpu_run(cell: str, seed: int = 5, seconds: float = 0.6,
            trace: bool = False, control: bool = False):
    """One run of a fixture cell on the CPU; the result dict."""
    import run as bench
    return bench.run_cell(cell, seed, seconds, trace, "cpu", control,
                          data_dir=FIXTURES,
                          bench_json=FIXTURES / "BENCHMARK.json",
                          t_start=time.perf_counter())
