"""Motion-seg training data: FlyingThings3D sequence dataset, synthetic
scenes, the flow PNG16 codec and the ground-truth trajectory labels (port of
particlesfm_tpu/motionseg/data.py; numpy and PIL only).

The layout follows the reference's dataset layer
(motion_seg/core/dataset/flythings3d_seq.py and data_utils.py):
  - per 10-frame sequence directory: RGB frames, GT flow as 16-bit PNGs with
    the (value - 32000) / 100 encoding, binary motion masks, MiDaS-style
    depth PNGs, and precomputed padded trajectories pt.npz [N, L, 2]
    + pad_mask.npz + traj_label.npy;
  - random trajectory cap at traj_max_num.

The loader is a plain host-side iterator producing padded numpy batches with
static shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
from PIL import Image

FLOW_PNG_OFFSET = 32000.0
FLOW_PNG_SCALE = 100.0


def encode_flow_png16(flow: np.ndarray) -> np.ndarray:
    """Float flow -> uint16 with the reference's (v*100 + 32000) encoding."""
    return np.clip(flow * FLOW_PNG_SCALE + FLOW_PNG_OFFSET, 0, 65535).astype(np.uint16)


def decode_flow_png16(raw: np.ndarray) -> np.ndarray:
    """(value - 32000) / 100 decoding (data_utils.py:23-27)."""
    return (raw.astype(np.float32) - FLOW_PNG_OFFSET) / FLOW_PNG_SCALE


def write_flow_png(path, flow: np.ndarray) -> None:
    """Two-channel flow as a stacked [H, 2W] 16-bit PNG (u then v)."""
    enc = encode_flow_png16(flow)
    Image.fromarray(np.concatenate([enc[..., 0], enc[..., 1]], axis=1), mode="I;16").save(path)


def read_flow_png(path) -> np.ndarray:
    raw = np.asarray(Image.open(path))
    W = raw.shape[1] // 2
    return np.stack(
        [decode_flow_png16(raw[:, :W]), decode_flow_png16(raw[:, W:])], axis=-1
    )


def find_traj_label(traj: np.ndarray, valid: np.ndarray, motion_masks: np.ndarray,
                    frame_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-trajectory binary label by majority vote of the GT motion mask at the
    trajectory's points (prepare_flyingthings3d.py find_traj_label:85-103).

    traj [N, L, 2] pixel coords, valid [N, L], motion_masks [L, H, W] (or [T, H, W]
    with frame_ids [L]). Returns [N] float {0, 1}.
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


@dataclass
class SeqSample:
    traj: np.ndarray        # [N, L, 2] normalized to [0, 1]
    depth: np.ndarray       # [L, h, w] in [0, 1]
    valid: np.ndarray       # [N, L] bool
    label: np.ndarray       # [N] float
    traj_valid: np.ndarray  # [N] bool


class FlyingThingsSeqDataset:
    """Prepared FlyingThings3D sequence directories -> training samples.

    Layout per sequence dir (written by scripts/prepare_flyingthings3d.py):
        pt.npz (key 'traj' [N, L, 2] pixel coords), pad_mask.npz (key 'mask'
        [N, L] True=valid), traj_label.npy [N], depth/*.png (16-bit).
    """

    def __init__(self, root, resolution=(272, 480), traj_max_num=100_000,
                 image_hw=None, seed=0):
        self.dirs = sorted(p for p in Path(root).iterdir() if (p / "pt.npz").exists())
        if not self.dirs:
            raise FileNotFoundError(f"no prepared sequences under {root}")
        self.resolution = resolution
        self.traj_max_num = traj_max_num
        self.image_hw = image_hw
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.dirs)

    def __getitem__(self, idx) -> SeqSample:
        from ..io.images import read_depth_png16

        d = self.dirs[idx]
        traj = np.load(d / "pt.npz")["traj"].astype(np.float32)
        valid = np.load(d / "pad_mask.npz")["mask"].astype(bool)
        label = np.load(d / "traj_label.npy").astype(np.float32)
        if len(traj) > self.traj_max_num:     # random cap (data_utils.py:63-72)
            sel = self.rng.choice(len(traj), self.traj_max_num, replace=False)
            traj, valid, label = traj[sel], valid[sel], label[sel]
        depth_files = sorted((d / "depth").glob("*.png"))
        h, w = self.resolution
        depths = []
        for p in depth_files:
            dep = read_depth_png16(p)
            img = Image.fromarray((dep * 65535).astype(np.uint16), mode="I;16")
            depths.append(np.asarray(img.resize((w, h), Image.BILINEAR), np.float32) / 65535.0)
        depth = np.stack(depths)
        img_hw = self.image_hw or (depth_files and Image.open(depth_files[0]).size[::-1])
        traj_norm = traj / np.array([img_hw[1], img_hw[0]], np.float32)
        return SeqSample(
            traj=traj_norm, depth=depth, valid=valid, label=label,
            traj_valid=valid.any(axis=1),
        )

    def batches(self, batch_size: int, pad_tracks: int, shuffle=True) -> Iterator[dict]:
        """Yield padded numpy batches with static shapes."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            samples = [self[int(i)] for i in order[start : start + batch_size]]
            L = samples[0].traj.shape[1]
            h, w = samples[0].depth.shape[1:]
            B = batch_size
            traj = np.zeros((B, pad_tracks, L, 2), np.float32)
            valid = np.zeros((B, pad_tracks, L), bool)
            label = np.zeros((B, pad_tracks), np.float32)
            tvalid = np.zeros((B, pad_tracks), bool)
            depth = np.zeros((B, L, h, w), np.float32)
            for b, s in enumerate(samples):
                n = min(len(s.traj), pad_tracks)
                traj[b, :n] = s.traj[:n]
                valid[b, :n] = s.valid[:n]
                label[b, :n] = s.label[:n]
                tvalid[b, :n] = s.traj_valid[:n]
                depth[b, : s.depth.shape[0]] = s.depth[:L]
            yield {
                "traj": traj, "depth": depth, "valid": valid,
                "label": label, "traj_valid": tvalid,
            }


def synthetic_motion_batch(rng, B=4, N=64, L=10, H=34, W=60, dyn_frac=0.35):
    """Synthetic labeled batch (static smooth field vs drifting outliers) for
    trainer tests and smoke training without the FlyingThings3D download."""
    base = rng.uniform(0.15, 0.85, (B, N, 1, 2))
    t = np.arange(L).reshape(1, 1, L, 1) / L
    label = (rng.random((B, N)) < dyn_frac).astype(np.float32)
    static_m = np.concatenate([0.06 * t, 0.01 * t], -1)
    dyn_m = np.concatenate(
        [rng.uniform(-0.2, 0.2, (B, N, 1, 1)) * t, rng.uniform(0.05, 0.25, (B, N, 1, 1)) * t], -1
    )
    traj = base + np.where(label[..., None, None] > 0, dyn_m, static_m)
    return {
        "traj": traj.astype(np.float32),
        "depth": rng.uniform(0.2, 0.8, (B, L, H, W)).astype(np.float32),
        "valid": np.ones((B, N, L), bool),
        "label": label,
        "traj_valid": np.ones((B, N), bool),
    }
