"""k1_roofline: kernel K1's share of its byte bound over the traced
window. Bytes: the frozen `lookup_bytes` over the coordinates of every K1
launch (the harness wraps the RAFT model's `lookup`); divided by the HBM
peak and by the device time of the kernels whose name holds KERNEL_PATTERN."""

import bench_yardstick as Y

LAYER = "K1"
UNIT = "%"
KERNEL_PATTERN = "corr_lookup_kernel"


def install(ctx):
    """Before any RAFT is built: models built later take the wrapper as
    their `lookup` attribute."""
    from particlesfm_tpu_torch.models import raft

    orig = raft.lookup_corr
    store = ctx.stash.setdefault("k1", [])

    def lookup_corr(pyramid, coords, radius=4):
        if ctx.recording:
            store.append(([tuple(c.shape[-2:]) for c in pyramid], coords.detach().clone(), radius))
        return orig(pyramid, coords, radius)

    raft.lookup_corr = lookup_corr


def read(ctx):
    store = ctx.stash.get("k1")
    if ctx.events is None or not store:
        return None
    secs = sum(t - s for n, s, t in ctx.events["device"] if KERNEL_PATTERN in n) / 1e9
    if secs <= 0:
        return None
    nbytes = sum(Y.lookup_bytes(shapes, c, r) for shapes, c, r in store)
    return 100.0 * nbytes / Y.PEAKS["hbm_bytes"] / secs
