"""sfm.positions.s_per_seq: seconds per completed sequence in the program's
`sfm.positions` spans (`sfm/mapper.py` `_position_and_refine`: glomap,
MFAS, triplets, LUD, linear or nonlinear positions), timed on the device."""

import bench_spans

LAYER = "SfM stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "sfm.positions")
