"""Batched rotation parameterizations: quaternion (w,x,y,z), angle-axis, matrices
(port of particlesfm_tpu/geometry/rotations.py).

COLMAP conventions: qvec = (w, x, y, z), world->cam. Every function is
batched over leading dimensions and computes on its input's device.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (both (..., 4), wxyz)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, broadcasting (as jnp.cross)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Robust matrix->quaternion (Shepperd's method, branch-free)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1 + m11 - m00 - m22, m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 + m22 - m00 - m11], dim=-1)
    scores = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 + m11 - m00 - m22,
                          1 + m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1, keepdim=True)      # first max, as jnp
    cands = torch.stack([q0, q1, q2, q3], dim=-2)          # (..., 4 cands, 4)
    q = torch.gather(cands, -2, best[..., None].expand(best.shape + (4,)))[..., 0, :]
    sc = torch.gather(scores, -1, best)
    q = q * (0.5 / torch.sqrt(torch.clamp(sc, min=_EPS)))
    q = torch.where(q[..., :1] < 0, -q, q)                 # canonical sign: w >= 0
    return quat_normalize(q)


def angle_axis_to_quat(aa: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    half = 0.5 * theta
    k = torch.where(theta > 1e-6, torch.sin(half) / torch.clamp(theta, min=_EPS),
                    0.5 - theta * theta / 48.0)
    return torch.cat([torch.cos(half), aa * k], dim=-1)


def quat_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(sin_half, w)
    k = torch.where(sin_half > 1e-6, theta / torch.clamp(sin_half, min=_EPS),
                    2.0 + theta * theta / 12.0)
    return v * k


def angle_axis_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    return quat_to_rotmat(angle_axis_to_quat(aa))


def rotmat_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    return quat_to_angle_axis(rotmat_to_quat(R))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ u == v x u. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def rotation_geodesic_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between rotation matrices, batched."""
    Rab = Ra @ Rb.transpose(-1, -2)
    tr = Rab[..., 0, 0] + Rab[..., 1, 1] + Rab[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


def quat_geodesic_angle(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    d = (quat_normalize(qa) * quat_normalize(qb)).sum(-1).abs()
    return 2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0))


def project_to_rotmat(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix (Frobenius) via SVD, batched, det = +1 enforced."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones(M.shape[:-2] + (2,), dtype=M.dtype, device=M.device),
                   det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt
