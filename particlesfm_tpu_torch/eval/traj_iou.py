"""Trajectory motion-label evaluation vs ground-truth rigidity masks.

Parity with upstream motion_seg/eval_traj_iou.py:67-142: per image, sample
the GT dynamic-region mask at every trajectory observation in that frame and
compare with the predicted per-observation label; report IoU / precision /
recall / F1 averaged over images. The reference excludes 9 degenerate Sintel
sequences (eval_traj_iou.py:121-125) — exposed here as DEGENERATE_SINTEL_SEQS. A copy of
particlesfm_tpu/eval/traj_iou.py.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..tracks.store import TrackArrays

DEGENERATE_SINTEL_SEQS = (
    "alley_1", "bamboo_1", "bandage_1", "bandage_2", "mountain_1",
    "shaman_2", "shaman_3", "sleeping_1", "sleeping_2",
)


def trajectory_label_metrics(
    tracks: TrackArrays,
    gt_masks: np.ndarray,          # [T, H, W] bool/0-1, True where DYNAMIC
) -> Dict[str, float]:
    """Mean per-image IoU / precision / recall / F1 of predicted traj labels."""
    assert tracks.labels is not None, "tracks must be labeled (run motion seg)"
    T, H, W = gt_masks.shape
    ious, precs, recs, f1s = [], [], [], []
    for t in range(min(T, tracks.num_frames)):
        obs = tracks.mask[:, t]
        if not obs.any():
            continue
        xy = tracks.xy[obs, t]
        x = np.clip(np.round(xy[:, 0]).astype(int), 0, W - 1)
        y = np.clip(np.round(xy[:, 1]).astype(int), 0, H - 1)
        gt = gt_masks[t, y, x] > 0.5
        pred = tracks.labels[obs, t] > 0
        inter = np.sum(pred & gt)
        union = np.sum(pred | gt)
        iou = inter / union if union else 1.0
        prec = inter / pred.sum() if pred.sum() else 1.0
        rec = inter / gt.sum() if gt.sum() else 1.0
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
        ious.append(iou)
        precs.append(prec)
        recs.append(rec)
        f1s.append(f1)
    return {
        "iou": float(np.mean(ious)) if ious else 0.0,
        "precision": float(np.mean(precs)) if precs else 0.0,
        "recall": float(np.mean(recs)) if recs else 0.0,
        "f1": float(np.mean(f1s)) if f1s else 0.0,
        "num_images": float(len(ious)),
    }
