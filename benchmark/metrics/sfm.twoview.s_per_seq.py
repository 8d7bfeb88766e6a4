"""sfm.twoview.s_per_seq: seconds per completed sequence in the program's
`sfm.twoview` spans (`sfm/mapper.py`, each mapper start: both relative-pose
RANSAC passes, epipolar votes, dynamic-track filters, in-mapper selfcal,
two-view classification, largest component), timed on the device."""

import bench_spans

LAYER = "SfM stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "sfm.twoview")
