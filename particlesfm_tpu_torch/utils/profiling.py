"""Per-stage wall-clock timers.

`StageTimer` writes the same `timings.txt` report as
particlesfm_tpu/utils/profiling.py (the format bench.py:79-86 parses). Stages
that launch CUDA work must synchronize before they end for the time to cover
the device work; the pipeline stages do.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    def __init__(self, report_path=None):
        """report_path: optional file updated after EVERY stage, so an
        externally budgeted caller always sees the completed stages even if a
        later stage never finishes."""
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.report_path = report_path

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if self.report_path is not None:
                try:
                    tmp = f"{self.report_path}.tmp"
                    with open(tmp, "w") as f:
                        f.write(self.report() + "\n")
                    os.replace(tmp, self.report_path)
                except OSError:
                    pass

    def report(self) -> str:
        lines = ["stage timings:"]
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"  {name:<28} {t:8.3f}s  x{self.counts[name]:<4} "
                f"({100 * t / max(total, 1e-9):5.1f}%)"
            )
        lines.append(f"  {'TOTAL':<28} {total:8.3f}s")
        return "\n".join(lines)
