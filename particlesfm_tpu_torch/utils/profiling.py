"""Per-stage wall-clock timers, program spans and counters, and an opt-in
profiler trace.

`StageTimer` writes the same `timings.txt` report as
particlesfm_tpu/utils/profiling.py (the format bench.py:79-86 parses). Its
times are host time: CUDA work runs asynchronously, so a stage's time covers
its device work only where the stage ends by reading its results back to the
host (the tracker's assembly, motion seg's labels, SfM's model); depth's
stage returns device tensors and does not, and its device tail falls into
the next stage's time. With tracing on, each stage is also a span timed on
its device (below), which covers its own device work; the report stays host
time.

Spans and counters say where a run spends its time. Tracing is off unless a
caller turns it on with `enable()`; the pipeline never does, and no flag or
environment variable does. Off, `span` checks one module-level flag and
returns a shared no-op context, and `count` returns at once: no clock read,
no `record_function`, no CUDA event, no allocation. No span ever
synchronises a device. On:

- each span runs its body inside `torch.profiler.record_function(name)`, so
  it shows in any profiler trace (`trace()`'s Chrome trace, a benchmark's
  traced window);
- each span appends a `Record` to an in-memory list (`records()`): its name,
  its host start and end in ns on the profiler's clock (Unix-epoch ns,
  `time.time_ns`, the clock torch.profiler stamps its events on, so a
  span's interval falls on a device trace's timeline), and the counters
  that `count` added while it was the innermost open span;
- a span given a CUDA `device` also records a timing event on that device's
  current stream as it opens and as it closes. `Record.seconds()` is then
  the time between the stream reaching the two events: from the stream
  having finished the work queued before the span (or the host opening it,
  if later) to the stream having finished the span's own work (or the host
  closing it, if later). Spans in turn on one stream so split the stream's
  time between them, without holding the host back. Elsewhere (no device,
  or the CPU) `seconds()` is the host interval. Work the span puts on other
  streams is not covered.

Spans are opened and closed from one thread, innermost first.

`trace` is the counterpart of the reference's jax.profiler context: a
torch.profiler trace of host and CUDA activity, written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

_on = False
_records: List["Record"] = []
_open: List["Record"] = []  # the open spans, innermost last


@dataclass
class Record:
    name: str
    start_ns: int
    end_ns: int                  # 0 while the span is open
    counters: Dict[str, int] = field(default_factory=dict)
    marks: Optional[tuple] = None   # CUDA events at the span's start and end

    def seconds(self) -> float:
        """The span's time: on its device's stream where it has marks (this
        waits for the end mark), else on the host."""
        if self.marks is None:
            return (self.end_ns - self.start_ns) / 1e9
        a, b = self.marks
        b.synchronize()
        return a.elapsed_time(b) / 1e3


def enable():
    """Turn tracing on for this process."""
    global _on
    _on = True


def disable():
    """Turn tracing off; spans already open still close into `records()`."""
    global _on
    _on = False


def records() -> List[Record]:
    """The closed spans' records, in the order the spans started."""
    return [r for r in _records if r.end_ns]


def count(name: str, n: int = 1):
    """Add `n` to counter `name` of the innermost open span (tracing on; a
    count outside every span is dropped)."""
    if not _on or not _open:
        return
    c = _open[-1].counters
    c[name] = c.get(name, 0) + n


def _mark(device):
    """A timing event recorded on `device`'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Span:
    __slots__ = ("_name", "_dev", "_rf", "_rec", "_start")

    def __init__(self, name: str, device):
        self._name = name
        cuda = device is not None and torch.device(device).type == "cuda"
        self._dev = device if cuda else None

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        self._rec = Record(self._name, time.time_ns(), 0)
        self._start = _mark(self._dev) if self._dev is not None else None
        _records.append(self._rec)
        _open.append(self._rec)
        return self._rec

    def __exit__(self, *exc):
        try:
            if self._start is not None:
                self._rec.marks = (self._start, _mark(self._dev))
        finally:
            self._rec.end_ns = time.time_ns()
            _open.pop()
            self._rf.__exit__(*exc)
        return False


_NOOP = contextlib.nullcontext()


def span(name: str, device=None):
    """Context of one program span (a no-op while tracing is off). `device`:
    the device whose stream times the span."""
    if not _on:
        return _NOOP
    return _Span(name, device)


class _Steps:
    """Consecutive spans over straight-line code: calling it with a name ends
    the span it opened last and opens the next; leaving the context ends the
    last one, on a return or a raise alike."""
    __slots__ = ("_dev", "_cur")

    def __init__(self, device):
        self._dev, self._cur = device, None

    def __enter__(self):
        return self

    def __call__(self, name: str):
        self._end(None, None, None)
        self._cur = _Span(name, self._dev)
        self._cur.__enter__()

    def _end(self, *exc):
        cur, self._cur = self._cur, None
        if cur is not None:
            cur.__exit__(*exc)

    def __exit__(self, *exc):
        self._end(*exc)
        return False


class _NoSteps:
    __slots__ = ()

    def __enter__(self):
        return self

    def __call__(self, name: str):
        pass

    def __exit__(self, *exc):
        return False


_NO_STEPS = _NoSteps()


def steps(device=None):
    """`with steps(device=dev) as step: step("a"); ...; step("b"); ...`
    records spans "a" and "b" back to back (a no-op while tracing is off)."""
    if not _on:
        return _NO_STEPS
    return _Steps(device)


class StageTimer:
    def __init__(self, report_path=None, device=None):
        """report_path: optional file updated after EVERY stage, so an
        externally budgeted caller always sees the completed stages even if a
        later stage never finishes. Each stage is also a span of its name,
        timed on `device` with tracing on."""
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.report_path = report_path
        self.device = device

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name, device=self.device):
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
