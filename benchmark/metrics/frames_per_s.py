"""frames_per_s: frames of the sequences completed in the window over the
window's wall time (host clock, ending in a device synchronisation)."""

LAYER = "end to end"
UNIT = "frames/s"


def read(ctx):
    return ctx.frames_done / ctx.window_s if ctx.window_s > 0 else None
