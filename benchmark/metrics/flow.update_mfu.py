"""flow.update_mfu: the RAFT update loop's share of the card's float32 peak.
FLOPs: per pair, the frozen reference net's count at the configuration's
GRU iterations less its count at none (FlopCounterMode, as `mfu` counts
them), times the pairs the window's sequences ran; over the device seconds
of the program's `flow.update` spans (CUDA events on the block's stream) and
the float32 peak (the configuration runs float32, TF32 off). None where the
program has no such span or there is no card."""

import bench_spans
import bench_yardstick as Y
import reference

LAYER = "flow stage"
UNIT = "%"
install = bench_spans.install


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.done:
        return None
    secs = sum(r.seconds() for r in bench_spans.window_records(ctx, "flow.update"))
    if secs <= 0:
        return None
    cfg = ctx.cell.config
    rc = cfg["raft"]
    net = reference.load_raft(ctx.root / cfg["checkpoints"]["raft"], rc["width"])
    H, W = cfg["height"], cfg["width"]
    per_pair = Y.raft_pair_flops(net, H, W, rc["iters"]) - Y.raft_pair_flops(net, H, W, 0)
    pairs = sum(cap.n_pairs for _, cap, _ in ctx.done)
    return 100.0 * per_pair * pairs / secs / Y.PEAKS["fp32_flops"]
