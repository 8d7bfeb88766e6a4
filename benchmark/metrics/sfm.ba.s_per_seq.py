"""sfm.ba.s_per_seq: seconds per completed sequence in the program's
`sfm.ba` spans (`sfm/mapper.py` `_refine_and_finish`: triangulation, BA
rounds, view rescue, retriangulation, packing; and the scoring of finished
models between mapper starts), timed on the device."""

import bench_spans

LAYER = "SfM stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "sfm.ba")
