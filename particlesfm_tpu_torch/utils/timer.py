"""Per-stage timing + structured metrics.

Replaces the reference's ad-hoc wall-clock prints (upstream sfm/main_sfm.py:117-120,
colmap::Timer in gmapper) with a structured registry that can be dumped as
JSON. A copy of particlesfm_tpu/utils/timer.py.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import OrderedDict


class StageTimer:
    def __init__(self):
        self.times = OrderedDict()
        self.metrics = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def record(self, name: str, value) -> None:
        self.metrics[name] = value

    def summary(self) -> dict:
        return {"stage_seconds": dict(self.times), "metrics": dict(self.metrics)}

    def dump(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, default=float)

    def report(self) -> str:
        lines = [f"{k}: {v:.3f}s" for k, v in self.times.items()]
        return "\n".join(lines)
