"""Track tensor store: padded trajectory arrays + file I/O
(port of particlesfm_tpu/tracks/store.py:24-157).

Trajectories live as padded arrays `xy [N, T, 2]` + `mask [N, T]` keyed by
absolute frame index; `trajectories/tracks.npz` has the same layout in both
packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import profiling
from .engine import TrackerOutput


@dataclass
class TrackArrays:
    xy: np.ndarray               # [N, T, 2] float32, position at absolute frame t
    mask: np.ndarray             # [N, T] bool, True where observed
    labels: Optional[np.ndarray] = None  # [N, T] int8, 1 = dynamic (after motion seg)

    @property
    def num_tracks(self) -> int:
        return self.xy.shape[0]

    @property
    def num_frames(self) -> int:
        return self.xy.shape[1]

    @property
    def lengths(self) -> np.ndarray:
        return self.mask.sum(axis=1)

    def save(self, path) -> None:
        data = {"xy": self.xy, "mask": self.mask}
        if self.labels is not None:
            data["labels"] = self.labels
        np.savez(path, **data)

    @classmethod
    def load(cls, path) -> "TrackArrays":
        data = np.load(path)
        return cls(
            xy=data["xy"], mask=data["mask"],
            labels=data["labels"] if "labels" in data.files else None,
        )

    def to_reference_dict(self) -> dict:
        """The reference's labeled track.npy dict
        {row: {"locations" [L,2] f64, "frame_ids" [L] i64, "labels" [L] i64}}."""
        out = {}
        for i in range(self.num_tracks):
            t = np.nonzero(self.mask[i])[0]
            out[i] = {
                "locations": self.xy[i, t].astype(np.float64),
                "frame_ids": t.astype(np.int64),
                "labels": (self.labels[i, t].astype(np.int64) if self.labels is not None
                           else np.zeros(len(t), np.int64)),
            }
        return out

    @classmethod
    def from_reference_dict(cls, d: dict, num_frames: Optional[int] = None) -> "TrackArrays":
        """Padded arrays from the reference's dict, rows in track-id order."""
        n = len(d)
        if num_frames is None:
            num_frames = 1 + max(int(np.max(v["frame_ids"])) for v in d.values())
        xy = np.zeros((n, num_frames, 2), np.float32)
        mask = np.zeros((n, num_frames), bool)
        labels = np.zeros((n, num_frames), np.int8)
        for row, (_, v) in enumerate(sorted(d.items())):
            t = np.asarray(v["frame_ids"], np.int64)
            xy[row, t] = np.asarray(v["locations"], np.float32)
            mask[row, t] = True
            if "labels" in v:
                labels[row, t] = np.asarray(v["labels"], np.int8)
        return cls(xy=xy, mask=mask, labels=labels)


def assemble_tracks(out: TrackerOutput, min_len: int = 3) -> TrackArrays:
    """Reassemble the tracker's per-frame slot emissions into padded track
    arrays, dropping trajectories shorter than min_len (upstream's
    main_connect_point_trajectories.py:50-55).

    The arrays are built on the tracker's device and only the kept rows
    cross to the host, one copy per array. Positions are quantised there to
    the reference's u16 fixed point at 1/32 px (store.py:99-110): the clamped
    integer is below 2^16, so it and its product with 1/32 are exact in
    float32, and tracks.npz holds the values of the reference's u16 crossing
    bit for bit."""
    ids_tc = out.traj_ids
    T1, C = ids_tc.shape
    dev = ids_tc.device
    n = int(out.num_trajs)
    # the engine emits id=-1 exactly where valid=False; (id, frame) pairs are
    # unique, since a trajectory holds one slot at a time
    flat = torch.nonzero(ids_tc.reshape(-1) >= 0).squeeze(1)
    ids = ids_tc.reshape(-1)[flat].long()
    keep = torch.bincount(ids, minlength=n) >= min_len
    n_kept = int(keep.sum())
    # kept rows in ascending id order; a dropped trajectory's entries land in
    # the spare row n_kept, which is cut off before the fetch
    row = torch.where(keep, torch.cumsum(keep, 0) - 1, n_kept)[ids]
    del ids
    q = torch.clamp(torch.round(out.positions.reshape(-1, 2)[flat] * 32.0), 0, 65535)
    # through int32 as through the reference's u16: -0.0 becomes 0.0
    q = q.to(torch.int32).to(torch.float32)
    t = flat // C
    del flat
    xy = torch.zeros((n_kept + 1, T1, 2), dtype=torch.float32, device=dev)
    mask = torch.zeros((n_kept + 1, T1), dtype=torch.bool, device=dev)
    xy[row, t] = q * (1.0 / 32.0)
    mask[row, t] = True
    del row, t, q
    xy, mask = xy[:n_kept], mask[:n_kept]
    if dev.type == "cuda":
        profiling.count("tracks.fetch_bytes", xy.nbytes + mask.nbytes)
    # xy's copy is queued without a wait (into pinned memory from CUDA);
    # mask's blocking copy, behind it on the same stream, waits for both
    xy = xy.to("cpu", non_blocking=True)
    mask = mask.cpu()
    return TrackArrays(xy=xy.numpy(), mask=mask.numpy())


def sample_inside_window(
    tracks: TrackArrays,
    frame_ids: Sequence[int],
    min_length: int = 3,
    max_num_tracks: int = 100_000,
    rng: Optional[np.random.Generator] = None,
):
    """Padded window view: trajectories with >= min_length observations inside
    the window, randomly capped at max_num_tracks with numpy's generator, as
    the reference samples them.

    Returns (locations [K, L, 2], present [K, L] bool, traj_indices [K]).
    """
    frame_ids = np.asarray(frame_ids, np.int64)
    sub_mask = tracks.mask[:, frame_ids]  # [N, L]
    counts = sub_mask.sum(axis=1)
    cand = np.nonzero(counts >= min_length)[0]
    if len(cand) > max_num_tracks:
        rng = rng or np.random.default_rng(0)
        cand = rng.permutation(cand)[:max_num_tracks]
        cand.sort()
    locations = tracks.xy[cand][:, frame_ids]
    present = sub_mask[cand]
    locations = locations * present[..., None]
    return locations.astype(np.float32), present, cand
