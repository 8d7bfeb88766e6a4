"""flow.net.s_per_seq: seconds per completed sequence in the program's
`flow.net` spans (`flow/infer.py` `run_block`: the frame gather, padding and
RAFT with K1, per block of pairs), timed on the block's device."""

import bench_spans

LAYER = "flow stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "flow.net")
