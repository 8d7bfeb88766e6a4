"""Batched PnP: absolute pose from 2D-3D correspondences (DLT RANSAC + GN)
(port of particlesfm_tpu/globalsfm/pnp.py).

Fixed-trial hypotheses evaluated in one batch, then two rounds of pose-only
Gauss-Newton on the consensus set. The mapper's view rescue uses it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import rotations as rot
from ..geometry import se3
from .twoview import uniform_draws


class PnPResult(NamedTuple):
    q: torch.Tensor            # [4] world->cam
    t: torch.Tensor            # [3]
    inliers: torch.Tensor      # [M] bool
    num_inliers: torch.Tensor  # int32


def _dlt_pose(X, x, w):
    """DLT camera matrix from weighted 2D-3D pairs, batched over the leading
    axis of w. X [M, 3], x [M, 2] normalized, w [S, M]. Returns (q [S, 4], t [S, 3])."""
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=-1)           # [M, 4]
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -x[:, 0:1] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -x[:, 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=0) * torch.cat([w, w], dim=-1)[..., None]   # [S, 2M, 12]
    # The 12x12 normal matrix of a 6-point sample is rank-deficient by
    # design; its float32 null vector hangs on rounding (the reference's own
    # hypotheses move when its inputs are scaled by 1 +- 2^-22), so it is
    # formed and solved in float64, as the 8-point normal matrix is.
    A = A.double()
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = V[..., :, 0].reshape(-1, 3, 4).to(X.dtype)

    def decompose(Pm):
        U, S, Vt = torch.linalg.svd(Pm[..., :3])
        sgn = torch.sign(torch.linalg.det(U @ Vt))
        D = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
        R = (U * D[..., None, :]) @ Vt
        scale = S.mean(-1) * sgn
        scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)
        return rot.rotmat_to_quat(R), Pm[..., 3] / scale[..., None]

    # the null vector's sign is ambiguous: take the one putting the weighted
    # majority of points in front
    q_pos, t_pos = decompose(P)
    q_neg, t_neg = decompose(-P)
    front_pos = ((se3.pose_apply(q_pos[:, None], t_pos[:, None], X)[..., 2] > 0) * w).sum(-1)
    front_neg = ((se3.pose_apply(q_neg[:, None], t_neg[:, None], X)[..., 2] > 0) * w).sum(-1)
    use_neg = (front_neg > front_pos)[:, None]
    return torch.where(use_neg, q_neg, q_pos), torch.where(use_neg, t_neg, t_pos)


def _reproj_err2(q, t, X, x):
    x_cam = se3.pose_apply(q, t, X)
    z = x_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    err2 = ((x_cam[..., :2] / z_safe[..., None] - x) ** 2).sum(-1)
    return torch.where(z > 0, err2, torch.full_like(err2, float("inf")))


def refine_pose_gn(q, t, X, x, w, num_iters: int = 10):
    """Pose-only Gauss-Newton on normalized reprojection. w [M] weights."""
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(num_iters):
        x_cam = se3.pose_apply(q, t, X)
        z = x_cam[..., 2]
        z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        r = (x_cam[..., :2] / z_safe[..., None] - x) * w[..., None]
        iz = 1.0 / z_safe
        zero = torch.zeros_like(z)
        A = torch.stack([torch.stack([iz, zero, -x_cam[..., 0] * iz * iz], -1),
                         torch.stack([zero, iz, -x_cam[..., 1] * iz * iz], -1)], dim=-2)
        Jr = A @ -rot.skew(x_cam - t)
        J = torch.cat([Jr, A], dim=-1) * w[..., None, None]          # [M, 2, 6]
        Jf = J.reshape(-1, 6)
        g = Jf.T @ r.reshape(-1)
        H = Jf.T @ Jf + 1e-8 * eye6
        d = torch.linalg.solve_ex(H, -g[:, None])[0][:, 0]
        q = rot.quat_normalize(rot.quat_multiply(rot.angle_axis_to_quat(d[:3]), q))
        t = t + d[3:]
    return q, t


def estimate_pose_pnp(X, x, mask, thres_sq: float, num_hypotheses: int = 64,
                      u=None, generator=None) -> PnPResult:
    """X [M, 3] world points, x [M, 2] normalized coords, mask [M] bool,
    thres_sq the squared inlier threshold (normalized coords).
    u: injected draws [num_hypotheses, 6] (the reference's
    `uniform(key, (S, 6))`), else drawn from `generator`."""
    M = X.shape[0]
    S = num_hypotheses
    u = uniform_draws((S, 6), u, generator, X.device)
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    count = torch.clamp(mask.sum(), min=1).to(u.dtype)
    idx = order[(u * count).to(torch.int64)]                          # [S, 6]
    w = torch.zeros(S, M, dtype=X.dtype, device=X.device)
    w[torch.arange(S, device=X.device)[:, None], idx] = 1.0
    w = w * mask
    qs, ts = _dlt_pose(X, x, w)
    inl = (_reproj_err2(qs[:, None], ts[:, None], X, x) < thres_sq) & mask
    best = torch.argmax(inl.sum(-1))
    q, t = qs[best], ts[best]
    for _ in range(2):
        inl = (_reproj_err2(q, t, X, x) < thres_sq) & mask
        q, t = refine_pose_gn(q, t, X, x, inl.to(X.dtype))
    inl = (_reproj_err2(q, t, X, x) < thres_sq) & mask
    return PnPResult(q=q, t=t, inliers=inl, num_inliers=inl.sum().to(torch.int32))
