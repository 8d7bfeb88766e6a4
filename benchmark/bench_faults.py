"""Faults planted in the timed path, to show that `correct` catches them
(`tests/test_bench_harness.py` on the CPU) and to read what they do to the
numbers on the card (`calibrate.py --modes`). The benchmark's own runs never
plant one.

Each fault is a function of a monkeypatcher `mp` (pytest's `MonkeyPatch`):
`mp.setattr("module.attribute", value)` or `mp.setattr(obj, "name", value)`.
"""
from __future__ import annotations

import numpy as np
import torch


def _wrap(mp, path: str, fn):
    """Replace `path` (module.attr) by fn(orig)."""
    import importlib

    mod_name, attr = path.rsplit(".", 1)
    orig = getattr(importlib.import_module(mod_name), attr)
    mp.setattr(path, fn(orig))


def _net_flow(mp, fn):
    _wrap(mp, "particlesfm_tpu_torch.flow.infer._net_flow",
          lambda orig: lambda *a, **k: fn(orig(*a, **k)))


def _flat_depth(d):
    lo, hi = d.amin(dim=(-2, -1), keepdim=True), d.amax(dim=(-2, -1), keepdim=True)
    return 0.98 * (d - lo) / torch.clamp(hi - lo, min=1e-12)


def _tracks(mp, fn):
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    _wrap(mp, "particlesfm_tpu_torch.pipeline.stages.assemble_tracks",
          lambda orig: lambda *a, **k: TrackArrays(*fn(orig(*a, **k))))


def _split_chains(t):
    """Every trajectory cut in two at the middle frame, as two trajectories."""
    half = np.arange(t.mask.shape[1]) >= t.mask.shape[1] // 2
    a, b = t.mask & ~half, t.mask & half
    keep_a, keep_b = a.sum(1) > 0, b.sum(1) > 0
    return (np.concatenate([t.xy[keep_a], t.xy[keep_b]]),
            np.concatenate([a[keep_a], b[keep_b]]))


def _shift_frame(t, frame=1, px=1.0):
    xy = t.xy.copy()
    xy[:, frame] += px
    return xy, t.mask


def _ba_skipped(mp):
    from particlesfm_tpu_torch.globalsfm.ba import BAState

    def skipped(q, t, params, X, *a, **k):
        z = torch.zeros((), dtype=q.dtype, device=q.device)
        return BAState(q, t, X, params, z, z, 0)

    mp.setattr("particlesfm_tpu_torch.sfm.mapper.bundle_adjust", skipped)


def _lm_one_step(mp):
    _wrap(mp, "particlesfm_tpu_torch.sfm.mapper.bundle_adjust",
          lambda orig: lambda *a, **k: orig(*a, **dict(k, max_iterations=1)))


FAULTS = {
    # a step that returns its state unchanged: the refinement
    "refine_unchanged": lambda mp: mp.setattr(
        "particlesfm_tpu_torch.flow.refine.photometric_refine_scheduled",
        lambda i1, i2, flows, **k: flows),
    # half of each block left out, its flows taken from the other half
    "half_batch": lambda mp: _net_flow(
        mp, lambda f: torch.cat([f[: (len(f) + 1) // 2]] * 2)[: len(f)]),
    # an answer altered where it is produced: one flow of each block
    "flow_altered": lambda mp: _net_flow(mp, lambda f: torch.cat([f[:1] + 0.5, f[1:]])),
    # the depth net's answer altered: 2% less contrast
    "depth_altered": lambda mp: mp.setattr(
        "particlesfm_tpu_torch.models.depth.normalize_depth", _flat_depth),
    # the tracker: half its trajectories dropped, every chain broken in two,
    # one frame's positions moved by a pixel
    "tracks_halved": lambda mp: _tracks(mp, lambda t: (t.xy[::2], t.mask[::2])),
    "chains_broken": lambda mp: _tracks(mp, _split_chains),
    "tracks_altered": lambda mp: _tracks(mp, _shift_frame),
    # SfM: bundle adjustment returning its input, or cut to one LM step
    "ba_skipped": _ba_skipped,
    "lm_one_step": _lm_one_step,
}

# the faults that only a cell with SfM can show
SFM_FAULTS = ("ba_skipped", "lm_one_step")
