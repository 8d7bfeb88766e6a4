"""Reconstruction summary statistics.
(copy of particlesfm_tpu/sfm/stats.py; numpy only).

Native replacement for the reference's `compute_model_stats`, which shells out to
`colmap model_analyzer` and parses its stdout (upstream sfm/main_sfm.py:52-93).
Same quantities: registered images, points, observations, mean track length,
mean observations per registered image, mean reprojection error.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .mapper import Reconstruction


def compute_model_stats(rec: Reconstruction) -> Dict[str, float]:
    valid = rec.track_valid
    obs = rec.obs_mask & valid[:, None]
    num_obs = int(obs.sum())
    num_points = int(valid.sum())
    num_reg = rec.num_registered
    errs = rec.obs_error[obs] if num_obs else np.zeros(0)
    return {
        "num_images": float(rec.num_images),
        "num_reg_images": float(num_reg),
        "num_points3D": float(num_points),
        "num_observations": float(num_obs),
        "mean_track_length": float(num_obs / num_points) if num_points else 0.0,
        "mean_observations_per_image": float(num_obs / num_reg) if num_reg else 0.0,
        "mean_reprojection_error_px": float(errs.mean()) if num_obs else 0.0,
    }


def format_model_stats(stats: Dict[str, float]) -> str:
    return (
        f"Registered images: {int(stats['num_reg_images'])}/{int(stats['num_images'])}\n"
        f"Points: {int(stats['num_points3D'])}\n"
        f"Observations: {int(stats['num_observations'])}\n"
        f"Mean track length: {stats['mean_track_length']:.4f}\n"
        f"Mean observations per image: {stats['mean_observations_per_image']:.4f}\n"
        f"Mean reprojection error: {stats['mean_reprojection_error_px']:.4f}px"
    )
