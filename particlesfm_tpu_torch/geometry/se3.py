"""SE3 poses in COLMAP convention: x_cam = R @ x_world + t (world->cam)
(port of particlesfm_tpu/geometry/se3.py).

A pose is the pair (qvec (..., 4) wxyz, tvec (..., 3)); helpers are batched.
"""
from __future__ import annotations

import torch

from . import rotations as rot


def pose_compose(q_ab, t_ab, q_bc, t_bc):
    """P = P_ab * P_bc: x -> R_ab (R_bc x + t_bc) + t_ab."""
    return rot.quat_multiply(q_ab, q_bc), rot.quat_rotate(q_ab, t_bc) + t_ab


def pose_inverse(q, t):
    qi = rot.quat_conjugate(rot.quat_normalize(q))
    return qi, -rot.quat_rotate(qi, t)


def pose_apply(q, t, x):
    """Apply world->cam pose to points x (..., 3)."""
    return rot.quat_rotate(q, x) + t


def relative_pose(q1, t1, q2, t2):
    """Relative pose P12 such that x_cam2 = P12(x_cam1): P12 = P2 * P1^{-1}."""
    q1i, t1i = pose_inverse(q1, t1)
    return pose_compose(q2, t2, q1i, t1i)


def camera_center(q, t):
    """Projection center in world coords: C = -R^T t."""
    qi = rot.quat_conjugate(rot.quat_normalize(q))
    return -rot.quat_rotate(qi, t)


def pose_from_center(q, center):
    """tvec from rotation + world-space camera center: t = -R @ C."""
    return -rot.quat_rotate(q, center)


def pose_to_matrix(q, t):
    """(..., 3, 4) world->cam matrix [R|t]."""
    return torch.cat([rot.quat_to_rotmat(q), t[..., :, None]], dim=-1)
