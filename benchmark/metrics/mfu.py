"""mfu: FLOPs of the RAFT, depth and seg nets at the shapes the traced
window fed them, counted by FlopCounterMode over the frozen reference nets
(the same count whatever implements the nets), over the traced window's wall
time and the card's float32 peak (the configuration runs float32, TF32 off)."""

import bench_yardstick as Y
import reference

LAYER = "whole sequence"
UNIT = "%"


def read(ctx):
    if ctx.device.type != "cuda" or ctx.events is None or not ctx.done or ctx.window_s <= 0:
        return None
    cfg = ctx.cell.config
    ck = cfg["checkpoints"]
    H, W = cfg["height"], cfg["width"]
    raft = Y.raft_pair_flops(reference.load_raft(ctx.root / ck["raft"], cfg["raft"]["width"]),
                             H, W, cfg["raft"]["iters"])
    depth = seg_model = None
    if any(cap.depth_frames for _, cap, _ in ctx.done):
        depth = Y.depth_frame_flops(reference.load_depth(ctx.root / ck["depth"],
                                                         cfg["depth"]["base"]), H, W)
    seg = {}
    total = 0
    for _, cap, _ in ctx.done:
        total += raft * cap.n_pairs + (depth * cap.depth_frames if depth else 0)
        for shape in cap.seg_calls:
            if shape not in seg:
                seg_model = seg_model or reference.load_seg(ctx.root / ck["seg"],
                                                            cfg["seg"]["input_hw"])
                seg[shape] = Y.seg_call_flops(seg_model, shape)
            total += seg[shape]
    return 100.0 * total / ctx.window_s / Y.PEAKS["fp32_flops"]
