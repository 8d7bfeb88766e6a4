"""Track tensor store: padded trajectory arrays + file I/O
(port of particlesfm_tpu/tracks/store.py:24-131).

Trajectories live as padded arrays `xy [N, T, 2]` + `mask [N, T]` keyed by
absolute frame index; `trajectories/tracks.npz` has the same layout in both
packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

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


def assemble_tracks(out: TrackerOutput, min_len: int = 3) -> TrackArrays:
    """Reassemble the tracker's per-frame slot emissions into padded track
    arrays, dropping trajectories shorter than min_len (upstream's
    main_connect_point_trajectories.py:50-55).

    Positions cross to the host as u16 fixed point at 1/32 px, as the
    reference does (store.py:99-110), so both packages write the same
    quantized tracks.npz."""
    q = torch.clamp(torch.round(out.positions * 32.0), 0, 65535).to(torch.int32)
    positions = q.cpu().numpy().astype(np.uint16).astype(np.float32) * (1.0 / 32.0)
    traj_ids = out.traj_ids.cpu().numpy()
    # the engine emits id=-1 exactly where valid=False
    valid = traj_ids >= 0
    n = int(out.num_trajs)
    T1 = positions.shape[0]

    tv, cv = np.nonzero(valid)
    ids = traj_ids[tv, cv]

    xy = np.zeros((n, T1, 2), np.float32)
    mask = np.zeros((n, T1), bool)
    xy[ids, tv] = positions[tv, cv]
    mask[ids, tv] = True

    keep = mask.sum(axis=1) >= min_len
    return TrackArrays(xy=xy[keep], mask=mask[keep])
