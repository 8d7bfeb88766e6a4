"""Batched PnP: absolute pose from 2D-3D correspondences (DLT RANSAC + GN)
(port of particlesfm_tpu/globalsfm/pnp.py).

Fixed-trial hypotheses evaluated in one batch, then two rounds of pose-only
Gauss-Newton on the consensus set. The mapper's view rescue uses it.

Three decisions of the reference hang on the device (the port's deviations,
each held in tests/test_torch_globalsfm.py):
- The null vector. Where a 6-point sample is degenerate (its normal
  matrix has two or more null directions: points on a line, a point drawn
  twice) the eigensolver returns any vector of that space, and LAPACK and
  cuSOLVER return different ones. The port gives such a sample no
  hypothesis; when no hypothesis explains a point, the estimate fails.
- P or -P. The reference keeps the pose that puts more of the 6-point
  sample in front. Where both put as many in front, it keeps whichever sign
  its eigensolver returned, and LAPACK and cuSOLVER return different signs.
  The port fixes the null vector's sign and takes the one with more inliers.
- The Gauss-Newton polish. When the best hypothesis explains one or two
  points, the first round solves a 6x6 system of rank <= 4 damped by 1e-8;
  in float32 its step is set by the rounding of the sums, so the device's
  summation order decides the pose. The whole estimate runs in float64 and
  returns the pose in the inputs' dtype.
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
    """DLT camera matrices from weighted 2D-3D pairs, batched over the leading
    axis of w. X [M, 3], x [M, 2] normalized, w [S, M]. Returns the poses of
    P and of -P (q [S, 2, 4], t [S, 2, 3]), the weighted count of points
    each puts in front ([S, 2]; the caller picks one of the two), and
    whether the sample is degenerate ([S]: a null space of two or more
    dimensions, as of 6 points on a line or a point drawn twice, where the
    null vector is whatever the eigensolver returns)."""
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=-1)           # [M, 4]
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -x[:, 0:1] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -x[:, 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=0) * torch.cat([w, w], dim=-1)[..., None]   # [S, 2M, 12]
    # The 12x12 normal matrix of a 6-point sample is rank-deficient by
    # design; its float32 null vector hangs on rounding (the reference's own
    # hypotheses move when its inputs are scaled by 1 +- 2^-22), so the whole
    # estimate is float64, as the 8-point normal matrix is.
    ev, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    # second-smallest eigenvalue at the float64 noise floor (seq_03_dyn's
    # 10,304 incremental samples: 85 below 1e-15 of the largest, none in
    # [1e-15, 1e-13), the rest above)
    degenerate = ev[..., 1] <= 1e-14 * ev[..., -1]
    # The null vector's sign is the eigensolver's choice (LAPACK and cuSOLVER
    # differ): fix it, largest-magnitude entry positive.
    v = V[..., :, 0]
    v = v * torch.sign(v.gather(-1, v.abs().argmax(-1, keepdim=True)))
    P = torch.stack([v, -v], dim=1).reshape(-1, 2, 3, 4)

    U, S, Vt = torch.linalg.svd(P[..., :3])
    sgn = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    scale = S.mean(-1) * sgn
    scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)
    q, t = rot.rotmat_to_quat(R), P[..., 3] / scale[..., None]
    front = ((se3.pose_apply(q[..., None, :], t[..., None, :], X)[..., 2] > 0)
             * w[:, None]).sum(-1)
    return q, t, front, degenerate


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
    dtype = X.dtype
    X, x = X.double(), x.double()
    w = torch.zeros(S, M, dtype=X.dtype, device=X.device)
    w[torch.arange(S, device=X.device)[:, None], idx] = 1.0
    w = w * mask
    qs, ts, front, degenerate = _dlt_pose(X, x, w)
    score = ((_reproj_err2(qs[..., None, :], ts[..., None, :], X, x) < thres_sq)
             & mask).sum(-1) * ~degenerate[:, None]                  # [S, 2]
    # P or -P: the one putting the weighted majority of the sample in front
    # (the reference's rule); where both put as many in front, the one
    # with more inliers (the reference keeps its eigensolver's sign there)
    neg = (front[:, 1] > front[:, 0]) | ((front[:, 1] == front[:, 0])
                                         & (score[:, 1] > score[:, 0]))
    pick = neg.long()
    rows = torch.arange(S, device=X.device)
    qs, ts, score = qs[rows, pick], ts[rows, pick], score[rows, pick]
    best = torch.argmax(score)
    q, t = qs[best], ts[best]
    # no hypothesis explains a point: the estimate fails (the reference's
    # zero-weight polish leaves its pose as it is)
    found = score[best] > 0
    for _ in range(2):
        inl = (_reproj_err2(q, t, X, x) < thres_sq) & mask & found
        q, t = refine_pose_gn(q, t, X, x, inl.to(X.dtype))
    inl = (_reproj_err2(q, t, X, x) < thres_sq) & mask & found
    return PnPResult(q=q.to(dtype), t=t.to(dtype), inliers=inl,
                     num_inliers=inl.sum().to(torch.int32))
