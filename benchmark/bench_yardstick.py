"""The yardstick the per-layer metrics divide by: the card's published peaks,
the bytes a correlation lookup must move, and the FLOPs of the pipeline's
nets at the shapes a run fed them. Kept with the benchmark so that no change
to the program moves it.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
PEAKS = {
    "fp32_flops": 67e12,      # float32 outside the tensor cores (TF32 is off)
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes": 3.35e12,
}


def lookup_bytes(shapes, coords: torch.Tensor, radius: int = 4) -> int:
    """Bytes one windowed correlation lookup must move for these coordinates:
    the output written once, the coordinates read once, and each pixel's
    (2r+2)^2 window per level read once where it lies inside the map.
    shapes: the levels' (Hl, Wl); coords [B, P, 2] (x, y) at level-0 scale;
    the window of a level starts at floor(coords / 2^l) - r. (A frozen copy
    of the port's `ops/corr_lookup.py` `lookup_bytes`.)"""
    B, P = coords.shape[:2]
    r = radius
    window_elems = 0
    for lvl, (Hl, Wl) in enumerate(shapes):
        pt = coords.double() / 2 ** lvl
        n = []
        for c, size in ((pt[..., 0], Wl), (pt[..., 1], Hl)):
            lo = torch.floor(c).clamp(-1e9, 1e9).long() - r
            hi = lo + 2 * r + 1
            n.append((hi.clamp(max=size - 1) - lo.clamp(min=0) + 1).clamp(min=0))
        window_elems += int((n[0] * n[1]).sum())
    n_out = B * P * len(shapes) * (2 * r + 1) ** 2
    return 4 * (n_out + B * P * 2 + window_elems)


def count_flops(fn) -> int:
    """FLOPs of fn() as torch's FlopCounterMode counts them (convolutions,
    matrix products; gathers and elementwise work count nothing)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return int(fc.get_total_flops())


def raft_pair_flops(model, height: int, width: int, iters: int) -> int:
    """One pair through the reference RAFT at the padded frame size, on the
    meta device (shapes only)."""
    hp, wp = height + (-height) % 8, width + (-width) % 8
    m = model.to("meta")
    x = torch.zeros(1, hp, wp, 3, device="meta")
    return count_flops(lambda: m(x, x, iters))


def depth_frame_flops(model, height: int, width: int) -> int:
    m = model.to("meta")
    return count_flops(lambda: m(torch.zeros(1, 3, height, width, device="meta")))


def seg_call_flops(model, shape) -> int:
    """One seg call on trajectories of `shape` (B, K, L)."""
    B, K, L = shape
    h, w = model.input_hw
    m = model.to("meta")
    return count_flops(lambda: m(torch.zeros(B, K, L, 2, device="meta"),
                                 torch.zeros(B, L, h, w, device="meta"),
                                 torch.ones(B, K, L, dtype=torch.bool, device="meta")))
