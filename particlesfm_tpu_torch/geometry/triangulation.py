"""Batched DLT triangulation over padded track tensors
(port of particlesfm_tpu/geometry/triangulation.py)."""
from __future__ import annotations

import torch

from . import cameras, se3


def triangulate_dlt(proj: torch.Tensor, xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multiview DLT. proj: (..., K, 3, 4) world->normalized-image projections,
    xy: (..., K, 2) normalized coords, mask (..., K). Returns world points (..., 3).

    Inhomogeneous formulation (finite points): the rows x*P[2] - P[0] are
    linear in X, so the minimizer is one 3x3 normal-equation solve.
    """
    r0 = xy[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]
    r1 = xy[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    A4 = torch.stack([r0, r1], dim=-2) * mask[..., None, None]      # (..., K, 2, 4)
    A4 = A4.reshape(A4.shape[:-3] + (-1, 4))
    A = A4[..., :3]
    b = -A4[..., 3]
    AtA = A.transpose(-1, -2) @ A + 1e-10 * torch.eye(3, dtype=A.dtype, device=A.device)
    Atb = (A.transpose(-1, -2) @ b[..., None])
    # solve_ex: a singular system gives non-finite values (as jnp.linalg.solve
    # does) instead of raising; triangulate_tracks snaps those to the origin
    return torch.linalg.solve_ex(AtA, Atb)[0][..., 0]


def triangulate_two_view(q1, t1, q2, t2, x1, x2):
    """Two-view DLT for normalized coords x1, x2 (..., 2). Returns world points (..., 3)."""
    proj = torch.stack([se3.pose_to_matrix(q1, t1), se3.pose_to_matrix(q2, t2)], dim=-3)
    xy = torch.stack([x1, x2], dim=-2)
    return triangulate_dlt(proj, xy, torch.ones(xy.shape[:-1], dtype=xy.dtype, device=xy.device))


def point_depths(q, t, X):
    """Depth of world points X (..., 3) in cameras (q, t) (broadcasting)."""
    return se3.pose_apply(q, t, X)[..., 2]


def reprojection_errors(q, t, params, X, uv):
    """Pixel reprojection error of world points against observations."""
    return torch.linalg.vector_norm(
        cameras.project(params, se3.pose_apply(q, t, X)) - uv, dim=-1)


def triangulation_angles(centers: torch.Tensor, X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max pairwise ray angle (radians) per point. centers: (..., K, 3), X: (..., 3)."""
    rays = centers - X[..., None, :]
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-12)
    cosang = rays @ rays.transpose(-1, -2)
    pair = (mask[..., :, None] * mask[..., None, :]) > 0
    K = mask.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=mask.device)
    cosang = torch.where(pair & ~eye, cosang, torch.ones_like(cosang))
    return torch.arccos(torch.clamp(cosang.amin(dim=(-2, -1)), -1.0, 1.0))
