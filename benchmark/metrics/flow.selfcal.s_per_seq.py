"""flow.selfcal.s_per_seq: seconds per completed sequence in the program's
`flow.selfcal` span (`stages._write_flow_selfcal`: focal self-calibration
from the flows and selfcal.json), timed on the device."""

import bench_spans

LAYER = "flow stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "flow.selfcal")
