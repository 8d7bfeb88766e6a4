"""tracks.scan.s_per_seq: seconds per completed sequence in the program's
`tracks.scan` span (`stages.tracking_stage`: both occlusion checks and the
tracker's per-frame scan), timed on the device."""

import bench_spans

LAYER = "tracks"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "tracks.scan")
