"""Reduction of a torch.profiler trace of the window to what the per-layer
metrics and the result's `breakdown` read: device operation intervals, the
device's busy time as the union of those intervals (not the sum of their
times), the idle gaps between them named by the benchmark's stage span they
fell in, and the device time by operation name.
"""
from __future__ import annotations

from collections import defaultdict

SPAN_PREFIX = "bench."


class Profiler:
    """torch.profiler's Kineto tracer without the Python event tree that
    `torch.profiler.profile` builds on exit (minutes for a window of whole
    sequences): `stop()` returns the raw events."""

    def __init__(self, cuda: bool):
        from torch.autograd.profiler import ProfilerActivity

        self.acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())

    def start(self):
        import torch.autograd as A
        from torch.autograd.profiler import ProfilerConfig, ProfilerState, _ExperimentalConfig

        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                             _ExperimentalConfig())
        A._prepare_profiler(cfg, self.acts)
        A._enable_profiler(cfg, self.acts)

    def stop(self) -> list:
        import torch.autograd as A

        return A._disable_profiler().events()


def window_bounds(events, name: str = SPAN_PREFIX + "window") -> tuple:
    e = next(e for e in events if e.name() == name)
    return e.start_ns(), e.end_ns()


def reduce_trace(events, window_ns: tuple) -> dict:
    """Device intervals [(name, start_ns, end_ns)] and benchmark spans
    [(name, start_ns, end_ns)] inside `window_ns` (the traced window's
    bounds on the profiler's clock: the `bench.window` span)."""
    from torch.autograd import DeviceType

    lo, hi = window_ns
    device, spans = [], []
    for e in events:
        name = e.name()
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                spans.append((name[len(SPAN_PREFIX):], s, t))
            continue
        if e.is_user_annotation() or name.startswith(SPAN_PREFIX) or t <= s:
            continue
        s, t = max(s, lo), min(t, hi)
        if t > s:
            device.append((name, s, t))
    return {"device": device, "spans": spans}


def busy_intervals(device) -> list:
    """The union of device intervals, as sorted disjoint [start, end) pairs."""
    out = []
    for _, s, t in sorted(device, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def idle_gaps(busy, window_ns, spans) -> list:
    """Gaps [(stage, seconds)] of the window that no device interval covers,
    each named by the innermost benchmark stage span around its middle
    (`sequence` between stages, `harness` outside any sequence)."""
    lo, hi = window_ns
    edges, cur = [], lo
    for s, t in busy:
        if s > cur:
            edges.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        edges.append((cur, hi))
    ranked = sorted(spans, key=lambda x: x[2] - x[1])     # innermost first
    out = []
    for s, t in edges:
        mid = (s + t) // 2
        name = next((n for n, a, b in ranked if a <= mid < b and n != "window"), "harness")
        out.append((name, (t - s) / 1e9))
    return out


def device_time_by_name(device) -> dict:
    tot = defaultdict(float)
    for name, s, t in device:
        tot[name] += (t - s) / 1e9
    return dict(tot)


def breakdown(device, gaps, n: int = 10) -> dict:
    ops = sorted(device_time_by_name(device).items(), key=lambda x: -x[1])[:n]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in sorted(gaps, key=lambda x: -x[1])[:n]]}
