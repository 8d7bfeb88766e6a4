"""sfm.host_reads_per_seq: device-to-host copies (`Memcpy DtoH` in the device
trace) that start inside the program's `sfm` stage spans, per completed
sequence: the host syncs of the SfM stage, each one a wait of the host on
the device. The program's spans and the device trace share the profiler's
clock. None on the CPU."""

import bench_spans

LAYER = "SfM stage"
UNIT = "reads"
install = bench_spans.install


def read(ctx):
    return bench_spans.host_reads_per_seq(ctx, "sfm")
