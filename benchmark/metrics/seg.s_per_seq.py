"""seg.s_per_seq: seconds of the depth and motion-seg stages together per
completed sequence, from the benchmark's spans around `stages.depth_stage`
and `stages.motionseg_stage`."""

LAYER = "depth and motion seg"
UNIT = "s"
SPANS = {"depth": "particlesfm_tpu_torch.pipeline.stages:depth_stage",
         "motionseg": "particlesfm_tpu_torch.pipeline.stages:motionseg_stage"}


def read(ctx):
    spans = ctx.span_s.get("depth", []) + ctx.span_s.get("motionseg", [])
    return sum(spans) / ctx.sequences if spans and ctx.sequences else None
