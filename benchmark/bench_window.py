"""What the harness attaches to the program: the capture of what each
sequence's timed path produced (for `correct`), and the benchmark's stage
spans for a traced run.

Both wrap module attributes that `pipeline/run.py` looks up at call time
(`stages.flow_stage`, `stages.depth_stage`, `run._load_seg_apply`, ...), so
the program itself is not edited. The captures are small: sampled flows and
depth frames, and one sampled seg call, copied to the host as they are made;
for the one sequence of a window whose trajectories are checked, also the
flows the tracker was given and the trajectories it returned.
"""
from __future__ import annotations

import functools
import importlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


def pair_index(T: int, path_consistency: bool = True):
    """The flow stage's pair list, in its order: forward stride 1, backward
    stride 1, then (with path consistency) forward and backward stride 2.
    Returns (names, ia, ib): the flow stack and row of each pair, frames."""
    names, ia, ib = [], [], []
    dirs = [("flow_f", 1), ("flow_b", -1)]
    if path_consistency:
        dirs += [("flow_f2", 2), ("flow_b2", -2)]
    for name, s in dirs:
        n = T - abs(s)
        names += [(name, i) for i in range(n)]
        ia += list(np.arange(n) + (0 if s > 0 else -s))
        ib += list(np.arange(n) + (s if s > 0 else 0))
    return names, np.array(ia), np.array(ib)


@dataclass
class Capture:
    """What one sequence's timed path produced, as far as it is checked."""
    rng: np.random.Generator
    n_flow: int
    n_depth: int
    pair_ia: Optional[np.ndarray] = None
    pair_ib: Optional[np.ndarray] = None
    flows: Optional[torch.Tensor] = None          # [n, H, W, 2], host
    n_pairs: int = 0
    depth_idx: Optional[np.ndarray] = None
    depth: Optional[torch.Tensor] = None          # [n, H, W], host
    depth_frames: int = 0
    seg: Optional[tuple] = None                   # (traj, depth, valid, logits), host
    tracks: bool = False                          # check this sequence's trajectories
    track_flows: Optional[dict] = None            # the tracker's input flows, host
    track_out: Optional[tuple] = None             # (xy, mask) it returned, host
    seg_calls: list = field(default_factory=list)  # (B, K, L) of every call
    _seg_seen: int = 0
    _seg_depth: tuple = (None, None)


class Hooks:
    """The captures (every run) and the stage spans (traced runs)."""

    def __init__(self):
        from particlesfm_tpu_torch.pipeline import run as run_mod
        from particlesfm_tpu_torch.pipeline import stages

        self.run_mod, self.stages = run_mod, stages
        self.cap: Optional[Capture] = None
        self._undo = []

    def install_captures(self):
        """After any spans, so that a span's time leaves the copies out."""
        self._patch(self.stages, "flow_stage", self._flow)
        self._patch(self.stages, "depth_stage", self._depth)
        self._patch(self.stages, "tracking_stage", self._tracking)
        self._patch(self.run_mod, "_load_seg_apply", self._seg_loader)

    def _patch(self, mod, name, make):
        orig = getattr(mod, name)
        setattr(mod, name, functools.wraps(orig)(make(orig)))
        self._undo.append((mod, name, orig))

    def restore(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()

    def _flow(self, orig):
        def flow_stage(images, *a, **k):
            res = orig(images, *a, **k)
            cap = self.cap
            if cap is not None:
                names, ia, ib = pair_index(images.shape[0], "flow_f2" in res)
                pick = np.sort(cap.rng.choice(len(names), min(cap.n_flow, len(names)),
                                              replace=False))
                cap.pair_ia, cap.pair_ib, cap.n_pairs = ia[pick], ib[pick], len(names)
                cap.flows = torch.stack([res[names[i][0]][names[i][1]] for i in pick]).cpu()
            return res
        return flow_stage

    def _depth(self, orig):
        def depth_stage(images, *a, **k):
            deps = orig(images, *a, **k)
            cap = self.cap
            if cap is not None:
                T = images.shape[0]
                cap.depth_idx = np.sort(cap.rng.choice(T, min(cap.n_depth, T), replace=False))
                cap.depth = torch.as_tensor(deps)[torch.as_tensor(cap.depth_idx)].cpu()
                cap.depth_frames = T
            return deps
        return depth_stage

    def _tracking(self, orig):
        def tracking_stage(flows, *a, **k):
            tracks = orig(flows, *a, **k)
            cap = self.cap
            if cap is not None and cap.tracks:
                cap.track_flows = {n: torch.as_tensor(v).cpu() for n, v in flows.items()
                                   if n in ("flow_f", "flow_b", "flow_f2", "flow_b2")}
                cap.track_out = (np.array(tracks.xy), np.array(tracks.mask))
            return tracks
        return tracking_stage

    def _seg_loader(self, orig):
        def load_seg_apply(*a, **k):
            apply = orig(*a, **k)
            if apply is None:
                return None

            def recorded(traj, depth, valid):
                logits = apply(traj, depth, valid)
                cap = self.cap
                if cap is not None:
                    cap.seg_calls.append(tuple(np.asarray(traj).shape[:3]))
                    cap._seg_seen += 1
                    # reservoir sample of one call per sequence
                    if cap.rng.random() < 1.0 / cap._seg_seen:
                        if cap._seg_depth[0] != id(depth):     # one copy per stage
                            cap._seg_depth = (id(depth), torch.as_tensor(depth).cpu())
                        cap.seg = (np.array(traj), cap._seg_depth[1], np.array(valid),
                                   logits.cpu())
                return logits

            recorded.accepts_u16 = getattr(apply, "accepts_u16", False)
            recorded.threshold = getattr(apply, "threshold", None)
            return recorded
        return load_seg_apply

    def add_span(self, name: str, target: str, sink: dict, sync):
        """Wrap `module:function` in a profiler span `bench.<name>` that ends
        with a device synchronisation; its host seconds go to sink[name]."""
        mod_name, fn_name = target.split(":")
        mod = importlib.import_module(mod_name)
        sink.setdefault(name, [])

        def make(orig):
            def spanned(*a, **k):
                t0 = time.perf_counter()
                with torch.profiler.record_function("bench." + name):
                    out = orig(*a, **k)
                    sync()
                sink[name].append(time.perf_counter() - t0)
                return out
            return spanned

        self._patch(mod, fn_name, make)
