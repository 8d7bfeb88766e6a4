"""peak_gb: torch.cuda.max_memory_allocated over the window, after the peak
statistics were reset at its start (1 GB = 1e9 bytes)."""

LAYER = "end to end"
UNIT = "GB"


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.device.type == "cuda" else None
