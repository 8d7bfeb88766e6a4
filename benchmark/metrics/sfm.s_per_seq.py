"""sfm.s_per_seq: seconds of the SfM stage (global mapper through the
reconstruction manager, model and converted outputs) per completed sequence,
from the benchmark's span around `stages.sfm_stage`."""

LAYER = "SfM stage"
UNIT = "s"
SPANS = {"sfm": "particlesfm_tpu_torch.pipeline.stages:sfm_stage"}


def read(ctx):
    spans = ctx.span_s.get("sfm")
    return sum(spans) / ctx.sequences if spans and ctx.sequences else None
