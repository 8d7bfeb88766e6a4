"""Two-view epipolar geometry: E/F construction, Hartley normalization, the
normalized 8-point solve, the Sampson error and essential decomposition
(port of particlesfm_tpu/geometry/epipolar.py).

Solvers work on fixed-size point blocks batched over any leading axes, so
RANSAC evaluates every hypothesis of every pair in one call. The 8-point
normal matrix and its null vector are computed in float64 (the reference
uses float32), so the estimate does not depend on the device's rounding.
"""
from __future__ import annotations

import math

import torch

from . import rotations as rot
from .linalg3 import smallest_eigvec_psd, svd3x3


def essential_from_pose(q12: torch.Tensor, t12: torch.Tensor) -> torch.Tensor:
    """E for relative pose x2 = R12 x1 + t12:  x2^T E x1 = 0, E = [t]x R."""
    return rot.skew(t12) @ rot.quat_to_rotmat(q12)


def fundamental_from_essential(E, params1, params2):
    """F = K2^-T E K1^-1 with canonical packed params rows (fx, fy, cx, cy, k)."""
    return _kinv(params2).transpose(-1, -2) @ E @ _kinv(params1)


def _kinv(params):
    fx, fy, cx, cy, _ = params.unbind(-1)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    Ki = torch.stack([1.0 / fx, z, -cx / fx, z, 1.0 / fy, -cy / fy, z, z, o], dim=-1)
    return Ki.reshape(params.shape[:-1] + (3, 3))


def _hartley_normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Similarity normalization for conditioning; returns (pts_n, T) with T (3,3)."""
    w = mask[..., None]
    n = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    mean = (pts * w).sum(-2) / n
    d = torch.linalg.vector_norm((pts - mean[..., None, :]) * w, dim=-1)
    mean_d = d.sum(-1, keepdim=True) / n
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    s0 = s[..., 0]
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s0
    T[..., 1, 1] = s0
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -s0 * mean[..., 0]
    T[..., 1, 2] = -s0 * mean[..., 1]
    return (pts - mean[..., None, :]) * s[..., None], T


def eight_point(x1: torch.Tensor, x2: torch.Tensor, mask=None) -> torch.Tensor:
    """Normalized 8-point algorithm. x1, x2: (..., N, 2) with N >= 8; mask: (..., N).

    Returns F (or E if inputs are normalized camera coords), rank 2, unit
    Frobenius norm.
    """
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    x1n, T1 = _hartley_normalize(x1, mask)
    x2n, T2 = _hartley_normalize(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    # x2^T F x1 = 0 rows
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    # The normal matrix squares A's condition number: formed and solved in
    # float32, its null vector depends on summation order, and two devices
    # (or two implementations) pick different RANSAC winners. So it is
    # formed and solved in float64.
    A = (A * mask[..., None]).double()
    AtA = A.transpose(-1, -2) @ A
    f = smallest_eigvec_psd(AtA.reshape(-1, 9, 9)).reshape(AtA.shape[:-2] + (9,)).to(x1.dtype)
    # rank-2 enforcement (closed-form 3x3 svd)
    U, S, Vt = svd3x3(f.reshape(f.shape[:-1] + (3, 3)))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    nrm = torch.linalg.vector_norm(F.reshape(F.shape[:-2] + (9,)), dim=-1)
    return F / torch.clamp(nrm[..., None, None], min=1e-12)


def sampson_error(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) squared error. x1, x2: (..., N, 2)."""
    p1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    p2 = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Fp1 = p1 @ F.transpose(-1, -2)            # (F p1) per point
    Ftp2 = p2 @ F                             # (F^T p2) per point
    num = (p2 * Fp1).sum(-1) ** 2
    den = Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2 + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def essential_closest(E: torch.Tensor) -> torch.Tensor:
    """Project to the essential manifold: singular values -> (1, 1, 0)."""
    U, _, Vt = svd3x3(E)
    S = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * S) @ Vt


def decompose_essential(E: torch.Tensor):
    """E -> four (R, t) candidates stacked along a new leading axis of size 4
    (Hartley-Zisserman: R in {U W V^T, U W^T V^T}, t = +-u3)."""
    U, _, Vt = svd3x3(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([Ra, Ra, Rb, Rb], dim=0), torch.stack([t, -t, t, -t], dim=0)


def triangulate_midpoint_depths(R, t, x1, x2):
    """Cheap depths for cheirality voting: per-point 2x2 least squares for
    (d1, d2) with d2*x2h = R (d1*x1h) + t. Returns (d1, d2)."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    a = x1h @ R.transpose(-1, -2)                          # (..., N, 3)
    b = -x2h
    tt = t[..., None, :]
    aa = (a * a).sum(-1)
    bb = (b * b).sum(-1)
    ab = (a * b).sum(-1)
    at = (a * tt).sum(-1)
    bt = (b * tt).sum(-1)
    det = torch.clamp(aa * bb - ab * ab, min=1e-12)
    return (-at * bb + bt * ab) / det, (-bt * aa + at * ab) / det


def pose_from_essential(E, x1, x2, mask=None):
    """The (R, t) of decompose_essential with the most cheirality votes.

    x1, x2: normalized camera coords (..., N, 2). Returns (q12, t12, votes)."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    Rs, ts = decompose_essential(E)                        # (4, ..., 3, 3), (4, ..., 3)
    v = []
    for c in range(4):
        d1, d2 = triangulate_midpoint_depths(Rs[c], ts[c], x1, x2)
        v.append((((d1 > 0) & (d2 > 0)) * mask).sum(-1))
    v = torch.stack(v, dim=0)
    best = torch.argmax(v, dim=0)                          # first max, as jnp
    R = torch.gather(Rs, 0, best[None, ..., None, None].expand((1,) + Rs.shape[1:]))[0]
    t = torch.gather(ts, 0, best[None, ..., None].expand((1,) + ts.shape[1:]))[0]
    nv = torch.gather(v, 0, best[None])[0]
    return rot.rotmat_to_quat(R), t, nv
