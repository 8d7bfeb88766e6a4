"""flow.upload.s_per_seq: seconds per completed sequence in the program's
`frame_upload` span (`pipeline/run.py`: the frame stack's upload to the
device, inside the flow stage; its stage span, timed on the device)."""

import bench_spans

LAYER = "flow stage"
UNIT = "s"
install = bench_spans.install


def read(ctx):
    return bench_spans.s_per_seq(ctx, "frame_upload")
