"""flow.refine.s_per_seq: seconds per completed sequence in the program's
`flow.refine` spans (photometric refinement, per block in `flow/infer.py`
`run_block` or per direction in `stages._refine_standalone`), timed on the
device."""

import bench_spans

LAYER = "flow stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "flow.refine")
