"""flow.update.s_per_seq: seconds per completed sequence in the program's
`flow.update` spans (`models/raft.py` `RAFT.forward`: the GRU iterations
with their K1 lookups, once per block of pairs, inside `flow.net`), timed on
the block's device."""

import bench_spans

LAYER = "flow stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "flow.update")
