"""Per-stage wall-clock timers and an opt-in profiler trace.

`StageTimer` writes the same `timings.txt` report as
particlesfm_tpu/utils/profiling.py (the format bench.py:79-86 parses). Stages
that launch CUDA work must synchronize before they end for the time to cover
the device work; the pipeline stages do. `trace` is the counterpart of the
reference's jax.profiler context: a torch.profiler trace of host and CUDA
activity, written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace context; no-op when log_dir is None. Records CPU
    activity, and CUDA activity when CUDA is available, and writes a Chrome
    trace `trace_<pid>_<ns>.json` into `log_dir` when the context ends."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
