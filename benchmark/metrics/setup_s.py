"""setup_s: from the process's start to the window's: imports, CUDA, the
kernel library, rendering the pool, writing its frames, the warm-up."""

LAYER = "end to end"
UNIT = "s"


def read(ctx):
    return ctx.setup_s
