"""Ground-truth trajectory labels for scoring motion segmentation
(port of particlesfm_tpu/motionseg/data.py:52 `find_traj_label`)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def find_traj_label(traj: np.ndarray, valid: np.ndarray, motion_masks: np.ndarray,
                    frame_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-trajectory binary label by majority vote of the GT motion mask at
    the trajectory's points.

    traj [N, L, 2] pixel coords, valid [N, L], motion_masks [L, H, W] (or
    [T, H, W] with frame_ids [L]). Returns [N] float {0, 1}.
    """
    L = traj.shape[1]
    H, W = motion_masks.shape[1:3]
    fids = frame_ids if frame_ids is not None else np.arange(L)
    votes = np.zeros(traj.shape[0])
    counts = np.zeros(traj.shape[0])
    for k in range(L):
        obs = valid[:, k]
        if not obs.any():
            continue
        x = np.clip(np.round(traj[obs, k, 0]).astype(int), 0, W - 1)
        y = np.clip(np.round(traj[obs, k, 1]).astype(int), 0, H - 1)
        votes[obs] += motion_masks[fids[k], y, x] > 0.5
        counts[obs] += 1
    return (votes > 0.5 * np.maximum(counts, 1)).astype(np.float32)
