"""sfm.export.s_per_seq: seconds per completed sequence in the program's
`sfm.export` span (`stages.sfm_stage`: the COLMAP model files, the converted
outputs and the stats), timed on the device."""

import bench_spans

LAYER = "SfM stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "sfm.export")
