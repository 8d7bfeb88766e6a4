"""tracks.s_per_seq: seconds of the trajectory stage (occlusion checks, the
slot-pool tracker with path consistency, assembly, tracks.npz) per completed
sequence, from the benchmark's span around `stages.tracking_stage`."""

LAYER = "tracks"
UNIT = "s"
SPANS = {"tracks": "particlesfm_tpu_torch.pipeline.stages:tracking_stage"}


def read(ctx):
    spans = ctx.span_s.get("tracks")
    return sum(spans) / ctx.sequences if spans and ctx.sequences else None
