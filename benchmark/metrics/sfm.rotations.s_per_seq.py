"""sfm.rotations.s_per_seq: seconds per completed sequence in the program's
`sfm.rotations` spans (`sfm/mapper.py`, each mapper start: loop-consistency
gate, spanning tree, rotation averaging, orientation filter, re-averaging,
gauge anchors, observation upload), timed on the device."""

import bench_spans

LAYER = "SfM stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "sfm.rotations")
