"""The reference's labeled track.npy format (port of particlesfm_tpu/io/trackio.py).

Upstream stores raw trajectories as a pickled C++ `particlesfm.TrajectorySet`
(unreadable without its pybind module), but the LABELED tracks, the format
every downstream consumer reads, as a plain dict
{traj_id: {"locations" [L,2], "labels" [L], "frame_ids" [L]}}
(motion_seg/main_motion_segmentation.py:121-129). These helpers round-trip
that dict against the padded TrackArrays.
"""
from __future__ import annotations

import numpy as np

from ..tracks.store import TrackArrays


def save_reference_track_npy(path, tracks: TrackArrays) -> None:
    np.save(path, tracks.to_reference_dict(), allow_pickle=True)


def load_reference_track_npy(path, num_frames=None) -> TrackArrays:
    d = np.load(path, allow_pickle=True).item()
    return TrackArrays.from_reference_dict(d, num_frames=num_frames)
