"""flow.s_per_seq: seconds of the flow stage (the RAFT net with K1,
refinement, stride-2 fallback, selfcal) per completed sequence, from the
benchmark's own span around `stages.flow_stage`, synchronised at its end."""

LAYER = "flow stage"
UNIT = "s"
SPANS = {"flow": "particlesfm_tpu_torch.pipeline.stages:flow_stage"}


def read(ctx):
    spans = ctx.span_s.get("flow")
    return sum(spans) / ctx.sequences if spans and ctx.sequences else None
