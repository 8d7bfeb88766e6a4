"""Trajectory motion-segmentation inference: windowing + cross-window label merge
(port of particlesfm_tpu/motionseg/infer.py).

- cut the sequence into non-overlapping windows of `window_size`, the last
  one realigned to the sequence end;
- per window, take trajectories with >= min_length observations inside,
  capped at traj_max_num with numpy's generator (the reference's sample);
- run the model on every window at once, the track axis padded to the widest
  window and cut into equal chunks, threshold the sigmoid (the apply splits
  a chunk's windows over its device mesh itself);
- write each window's label onto every observation frame of each trajectory.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..tracks.store import TrackArrays, sample_inside_window


def cut_windows(num_frames: int, window_size: int) -> List[np.ndarray]:
    """Non-overlapping windows; last window realigned to the end."""
    if num_frames <= window_size:
        return [np.arange(num_frames)]
    starts = list(range(0, num_frames - window_size + 1, window_size))
    if starts[-1] + window_size < num_frames:
        starts.append(num_frames - window_size)
    return [np.arange(s, s + window_size) for s in starts]


def window_batch(
    tracks: TrackArrays,
    image_hw: Tuple[int, int],
    window_size: int = 10,
    traj_max_num: int = 100_000,
    min_length: int = 3,
    seed: int = 0,
    u16: bool = True,
):
    """The model's inputs for every window that has tracks.

    Returns (wins, samples, traj [B, K, L, 2], valid [B, K, L]): the windows,
    each window's (locs, present, rows) from `sample_inside_window` (numpy's
    generator seeded with `seed`, the reference's sample), and the track axis
    padded to the widest window K. `traj` is u16 fixed point (x 65535 / frame
    size, quantized on the host as the reference does: 1/65535 of the frame,
    ~0.016 px) when `u16`, else float32 in [0, 1]."""
    H, W = image_hw
    rng = np.random.default_rng(seed)
    wins, samples = [], []
    for win in cut_windows(tracks.num_frames, window_size):
        locs, present, rows = sample_inside_window(
            tracks, win, min_length=min_length, max_num_tracks=traj_max_num, rng=rng)
        if len(rows) == 0:
            continue
        wins.append(win)
        samples.append((locs, present, rows))
    kmax = max((s[0].shape[0] for s in samples), default=0)
    L = len(wins[0]) if wins else window_size
    traj = np.zeros((len(wins), kmax, L, 2), np.uint16 if u16 else np.float32)
    valid = np.zeros((len(wins), kmax, L), bool)
    norm = np.array([W, H], np.float32)
    for b, (locs, present, _rows) in enumerate(samples):
        k = locs.shape[0]
        if u16:
            traj[b, :k] = np.clip(np.round(locs * (65535.0 / norm)), 0, 65535)
        else:
            traj[b, :k] = locs / norm
        valid[b, :k] = present
    return wins, samples, traj, valid


def track_chunks(traj: np.ndarray, valid: np.ndarray, max_cells: int = 65536):
    """Cut the track axis into chunks of one size, the last zero-padded:
    [(traj, valid), ...] as the model sees them, one chunk unless the widest
    window holds more than max(1024, max_cells // B) tracks.

    The chunks bound peak memory (OANet activations ~64 KB per track slot).
    Instance norm and the soft cluster pooling run over each chunk, padded
    slots included, so the chunk size and zero padding are the reference's."""
    B, kmax = traj.shape[:2]
    chunk = max(1024, max_cells // max(B, 1))
    if kmax <= chunk:
        return [(traj, valid)]
    nch = -(-kmax // chunk)
    pad_k = nch * chunk - kmax
    traj = np.pad(traj, ((0, 0), (0, pad_k), (0, 0), (0, 0)))
    valid = np.pad(valid, ((0, 0), (0, pad_k), (0, 0)))
    return [(traj[:, c * chunk:(c + 1) * chunk], valid[:, c * chunk:(c + 1) * chunk])
            for c in range(nch)]


def segment_tracks(
    apply_fn: Callable,
    tracks: TrackArrays,
    depth_maps,                    # [T, H, W] relative depth in [0, 1], tensor or array
    image_hw: Tuple[int, int],     # original image resolution (for normalization)
    window_size: int = 10,
    traj_max_num: int = 100_000,
    min_length: int = 3,
    threshold: float = 0.5,
    seed: int = 0,
    max_cells: int = 65536,        # max windows x tracks per forward
    log=None,
) -> TrackArrays:
    """Label every track observation as static (0) / dynamic (1).

    apply_fn(traj [B,K,L,2] array, depth [B,L,H,W] tensor, valid [B,K,L] array)
    -> logits [B,K] tensor. `traj` is u16 fixed point (x 65535 / frame size)
    when apply_fn.accepts_u16, else float32 in [0, 1]. Each chunk is one
    call with every window. Returns TrackArrays with `labels`.
    """
    T = tracks.num_frames
    labels = np.zeros((tracks.num_tracks, T), np.int8)

    wins, samples, traj, valid = window_batch(
        tracks, image_hw, window_size, traj_max_num, min_length, seed,
        u16=bool(getattr(apply_fn, "accepts_u16", False)))
    if not wins:
        return TrackArrays(xy=tracks.xy, mask=tracks.mask, labels=labels)
    B, kmax = traj.shape[:2]
    depth_maps = torch.as_tensor(depth_maps)
    depth = depth_maps[torch.as_tensor(np.stack(wins), device=depth_maps.device)]

    chunks = track_chunks(traj, valid, max_cells)
    logits = torch.cat([apply_fn(t, depth, v) for t, v in chunks], dim=1)[:, :kmax]
    dyn_all = (torch.sigmoid(logits) > threshold).cpu().numpy()      # [B, kmax]
    if log is not None:
        log(f"[motionseg] {len(chunks)} chunks of {chunks[0][0].shape[1]} x {B} windows")

    for b, (locs, present, rows) in enumerate(samples):
        obs = present & dyn_all[b, :locs.shape[0]][:, None]
        frame_cols = np.broadcast_to(wins[b][None, :], present.shape)
        labels[rows[:, None], frame_cols] = np.where(
            obs, 1, labels[rows[:, None], frame_cols])
    return TrackArrays(xy=tracks.xy, mask=tracks.mask, labels=labels)
