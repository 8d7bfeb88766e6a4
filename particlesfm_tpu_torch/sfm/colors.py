"""Point colors + PLY export.

Counterparts of the reference's ExtractColorsForAllImages and PLY export
(upstream sfm/gmapper/src/base/reconstruction.cc:1221-1301, 918-1219):
each 3D point takes the image color at its first valid observation; PLY gives a
viewer-agnostic point-cloud + camera export (the reference's Open3D visualize.py
has no headless equivalent here). A copy of particlesfm_tpu/sfm/colors.py;
camera centres come from the port's geometry/se3.py.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..geometry import se3
from .mapper import Reconstruction


def extract_point_colors(rec: Reconstruction, images: np.ndarray) -> np.ndarray:
    """Per-point RGB from the first observation. images: [T, H, W, 3] uint8/float."""
    N = rec.points.shape[0]
    colors = np.full((N, 3), 128, np.uint8)
    H, W = images.shape[1:3]
    for n in np.nonzero(rec.track_valid)[0]:
        slots = np.nonzero(rec.obs_mask[n])[0]
        if len(slots) == 0:
            continue
        k = slots[0]
        img = int(rec.obs_frame_idx[n, k])
        u, v = rec.obs_uv[n, k]
        x = int(np.clip(round(u), 0, W - 1))
        y = int(np.clip(round(v), 0, H - 1))
        colors[n] = np.asarray(images[img, y, x], np.uint8)
    return colors


def write_ply(path, rec: Reconstruction, colors=None, include_cameras=True) -> None:
    """ASCII PLY of the sparse point cloud (+ camera centers in red)."""
    pts = rec.points[rec.track_valid]
    if colors is None:
        cols = np.full((len(pts), 3), 200, np.uint8)
    else:
        cols = colors[rec.track_valid]
    rows = [
        f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}" for p, c in zip(pts, cols)
    ]
    if include_cameras:
        centers = se3.camera_center(
            torch.as_tensor(rec.qvec, dtype=torch.float32),
            torch.as_tensor(rec.tvec, dtype=torch.float32),
        ).numpy()[rec.registered]
        rows += [f"{c[0]} {c[1]} {c[2]} 255 0 0" for c in centers]
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {len(rows)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    Path(path).write_text(header + "\n".join(rows) + "\n")
