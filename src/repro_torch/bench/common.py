"""Output helpers of the port's benchmarks (copies of the two that
``benchmarks/common.py`` gives the kernel benchmark)."""
from __future__ import annotations

import os
import time


def is_smoke() -> bool:
    """True when benchmarks run in the smoke path (tiny sizes)."""
    return os.environ.get("REPRO_BENCH_SMOKE", "") == "1"


class CsvOut:
    """One CSV line per row: ``<name>/<label>,<us per call>,<derived>``."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()

    def row(self, label: str, us_per_call: float, derived: str = ""):
        print(f"{self.name}/{label},{us_per_call:.3f},{derived}")

    def done(self):
        dt = (time.perf_counter() - self.t0) * 1e6
        print(f"{self.name}/TOTAL,{dt:.0f},wall_us")
