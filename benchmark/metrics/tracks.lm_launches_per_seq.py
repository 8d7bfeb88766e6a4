"""tracks.lm_launches_per_seq: launches of the tracker's path-consistency
kernel K2 per completed sequence, from the program's counter
`tracks.lm_kernel` (`tracks/optimize.py` `track_lm_cuda`: +1 a launch, one
a frame from the second on, inside the `tracks.scan` span)."""

import bench_spans

LAYER = "tracks"
UNIT = "launches"
install = bench_spans.install


def read(ctx):
    return bench_spans.count_per_seq(ctx, "tracks.lm_kernel")
