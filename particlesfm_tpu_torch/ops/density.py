"""Trajectory density control as a disc convolution (port of
particlesfm_tpu/ops/density.py).

"Nearest occupied pixel is farther than r" (upstream's EDT > sample_ratio
spawn rule, point_trajectory/trajectory.py:148-152) is exactly "no occupied
pixel within Euclidean distance <= r": one binary convolution with a disc.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def disc_kernel(radius: float) -> np.ndarray:
    """Binary disc: offsets with euclidean norm <= radius. Shape (2k+1, 2k+1)."""
    k = int(np.floor(radius))
    ys, xs = np.mgrid[-k : k + 1, -k : k + 1]
    return ((xs * xs + ys * ys) <= radius * radius).astype(np.float32)


def free_cell_mask(occupied: torch.Tensor, radius: float) -> torch.Tensor:
    """occupied: [H, W] (1.0 at active heads). Returns [H, W] 1.0 where
    EDT(1-occupied) > radius — i.e. where a new trajectory may spawn."""
    kern = torch.from_numpy(disc_kernel(radius)).to(occupied.device, occupied.dtype)
    kh, kw = kern.shape
    hits = F.conv2d(occupied[None, None], kern[None, None],
                    padding=(kh // 2, kw // 2))[0, 0]
    # hits are small integer counts; "< 0.5" is "== 0" and stays exact under
    # any summation order cuDNN picks
    return (hits < 0.5).to(occupied.dtype)
