"""sfm.pairs.s_per_seq: seconds per completed sequence in the program's
`sfm.pairs` spans (`sfm/mapper.py`, each mapper start: the static mask,
pair tensors and the tracks' upload), timed on the device."""

import bench_spans

LAYER = "SfM stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "sfm.pairs")
