"""The program's own spans and counters (`particlesfm_tpu_torch/utils/
profiling.py`) as the per-layer readers read them.

A reader's `install` turns the program's tracing on before set-up; readers
load only in traced runs, so untraced runs keep it off. A reader reads only
the records whose span started inside the traced window (`ctx.window_ns`, on
the profiler's clock, which the program's records share), so the warm-up
sequence is not counted. A span's seconds are the program's
`Record.seconds()`: the time its device's stream took over it where the
program timed it there, else its host interval. A program without the
recorder gives nothing to read, and the readers then return None.
"""
from __future__ import annotations


def _profiling():
    try:
        from particlesfm_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") and hasattr(profiling, "records") else None


def install(ctx):
    prof = _profiling()
    if prof is not None:
        prof.enable()


def window_records(ctx, name=None) -> list:
    """The program's records that started inside the traced window."""
    prof = _profiling()
    if prof is None or ctx.window_ns is None:
        return []
    lo, hi = ctx.window_ns
    return [r for r in prof.records()
            if lo <= r.start_ns < hi and (name is None or r.name == name)]


def s_per_seq(ctx, name):
    """Summed seconds of the spans `name` per completed sequence."""
    recs = window_records(ctx, name)
    if not recs or not ctx.sequences:
        return None
    return sum(r.seconds() for r in recs) / ctx.sequences


def count_per_seq(ctx, name):
    """Counter `name`, summed over every span, per completed sequence."""
    recs = [r for r in window_records(ctx) if name in r.counters]
    if not recs or not ctx.sequences:
        return None
    return sum(r.counters[name] for r in recs) / ctx.sequences


def host_reads_per_seq(ctx, stage):
    """Device-to-host copies ("Memcpy DtoH (Device -> Pageable)", "... ->
    Pinned)") that start inside the program's `stage` spans, per completed
    sequence; None without a device trace."""
    if ctx.device.type != "cuda" or ctx.events is None:
        return None
    spans = sorted((r.start_ns, r.end_ns) for r in window_records(ctx, stage))
    if not spans or not ctx.sequences:
        return None
    n = sum(1 for op, s, _ in ctx.events["device"]
            if op.startswith("Memcpy DtoH") and any(a <= s < b for a, b in spans))
    return n / ctx.sequences
