"""Trajectory plots for the pose eval harness.

Replaces the reference's `evo_traj` plot invocations
(upstream evaluation_evo/eval_sintel.py:85-89): top-down and 3D views of
the Sim3-aligned estimated trajectory against ground truth, written as PNGs.
A copy of particlesfm_tpu/eval/plots.py; matplotlib is imported only when a
plot is drawn.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from ..geometry.alignment import umeyama


def plot_trajectories(est_poses: Dict[str, np.ndarray],
                      gt_poses: Dict[str, np.ndarray],
                      out_png, title: str = "") -> None:
    """est/gt: stem -> 3x4 world2cam. Writes a 2-panel PNG (xy top-down + xz)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    common = sorted(set(est_poses) & set(gt_poses))
    if len(common) < 3:
        return

    def centers(poses):
        R = np.stack([poses[k][:, :3] for k in common])
        t = np.stack([poses[k][:, 3] for k in common])
        return -np.einsum("nji,nj->ni", R, t)

    est_c = centers(est_poses)
    gt_c = centers(gt_poses)
    s, R, t = umeyama(est_c, gt_c, with_scale=True)
    est_a = (s * (R @ est_c.T)).T + t

    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    for ax, (i, j, lab) in zip(axes, ((0, 1, "xy"), (0, 2, "xz"))):
        ax.plot(gt_c[:, i], gt_c[:, j], "k-", label="ground truth", lw=1.5)
        ax.plot(est_a[:, i], est_a[:, j], "-", color="tab:blue",
                label="estimate (Sim3-aligned)", lw=1.2)
        ax.scatter(gt_c[0, i], gt_c[0, j], c="k", marker="o", s=25)
        ax.set_xlabel(lab[0])
        ax.set_ylabel(lab[1])
        ax.set_aspect("equal", adjustable="datalim")
        ax.legend(fontsize=8)
    fig.suptitle(title or Path(out_png).stem)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
