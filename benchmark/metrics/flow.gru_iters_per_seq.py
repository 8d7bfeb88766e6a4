"""flow.gru_iters_per_seq: RAFT's GRU iterations per completed sequence, from
the program's counter `flow.gru_iters` (`models/raft.py` `RAFT.forward`:
+iters per call, one call per block of pairs)."""

import bench_spans

LAYER = "flow stage"
UNIT = "iterations"
install = bench_spans.install


def read(ctx):
    return bench_spans.count_per_seq(ctx, "flow.gru_iters")
