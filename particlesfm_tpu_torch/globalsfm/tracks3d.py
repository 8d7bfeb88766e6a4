"""Track triangulation + observation gating over padded track tensors
(port of particlesfm_tpu/globalsfm/tracks3d.py).

Every track is retriangulated at once by masked multiview DLT, then the
observation mask is recomputed from the gates: cheirality (depth > 0),
pixel reprojection error and triangulation angle. Re-running with the full
observation mask re-admits observations whose error dropped (COLMAP's
CompleteTracks).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import cameras, se3, triangulation


class TrackObs(NamedTuple):
    """Padded per-track observations: K observation slots per track."""
    frame_idx: torch.Tensor   # [N, K] int64 (0 for padded slots)
    uv: torch.Tensor          # [N, K, 2] pixel coords
    mask: torch.Tensor        # [N, K] bool


def triangulate_tracks(q, t, params, obs: TrackObs) -> torch.Tensor:
    """Masked multiview DLT for every track at once. Returns X [N, 3].

    Non-finite solutions (parallel rays, all-masked tracks) are snapped to
    the origin so downstream sums stay finite; the reprojection gates then
    discard them."""
    proj = se3.pose_to_matrix(q, t)[obs.frame_idx]           # [N, K, 3, 4]
    xy = cameras.img_to_cam(params, obs.uv)
    X = triangulation.triangulate_dlt(proj, xy, obs.mask.to(xy.dtype))
    return torch.where(torch.isfinite(X).all(-1, keepdim=True), X, torch.zeros_like(X))


def observation_errors(q, t, params, X, obs: TrackObs):
    """(reprojection error px [N, K], depth [N, K]) for every observation slot."""
    x_cam = se3.pose_apply(q[obs.frame_idx], t[obs.frame_idx], X[:, None, :])
    err = torch.linalg.vector_norm(cameras.project(params, x_cam) - obs.uv, dim=-1)
    return err, x_cam[..., 2]


def filter_observations(q, t, params, X, obs: TrackObs,
                        max_reproj_error_px: float = 4.0, min_tri_angle_deg: float = 1.5):
    """Gate observations and tracks against the current geometry.

    Returns (obs_mask [N, K] bool, track_valid [N] bool, err [N, K]):
    reprojection error, negative depth, minimum triangulation angle, >= 2
    surviving observations.
    """
    err, depth = observation_errors(q, t, params, X, obs)
    good = obs.mask & (depth > 1e-8) & (err <= max_reproj_error_px)
    centers = se3.camera_center(q, t)[obs.frame_idx]
    ang = triangulation.triangulation_angles(centers, X, good.to(err.dtype))
    track_valid = (good.sum(-1) >= 2) & (ang >= math.radians(min_tri_angle_deg))
    return good, track_valid, err
