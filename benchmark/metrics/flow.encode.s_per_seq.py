"""flow.encode.s_per_seq: seconds per completed sequence in the program's
`flow.encode` spans (`models/raft.py` `RAFT.forward`: both encoders and the
correlation pyramid, once per block of pairs, inside `flow.net`), timed on
the block's device."""

import bench_spans

LAYER = "flow stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "flow.encode")
