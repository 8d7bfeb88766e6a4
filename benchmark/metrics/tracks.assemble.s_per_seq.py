"""tracks.assemble.s_per_seq: seconds per completed sequence in the program's
`tracks.assemble` span (`stages.tracking_stage`: the tracks fetched to the
host, assembled and saved), timed on the device."""

import bench_spans

LAYER = "tracks"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "tracks.assemble")
