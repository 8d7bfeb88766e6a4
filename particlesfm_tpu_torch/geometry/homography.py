"""Batched homography estimation for planar-pair rejection
(port of particlesfm_tpu/geometry/homography.py:24-128).

4-point DLT through the same Hartley conditioning and 9x9 smallest
eigenvector (in float64) as the 8-point solver, the symmetric transfer
error, and a fixed-budget H-RANSAC over all pairs in lockstep.
"""
from __future__ import annotations

import torch

from ..globalsfm.twoview import sample_indices, uniform_draws
from .epipolar import _hartley_normalize
from .linalg3 import smallest_eigvec_psd


def dlt_homography(x1: torch.Tensor, x2: torch.Tensor, mask=None) -> torch.Tensor:
    """Masked DLT: H with x2 ~ H x1. x1, x2: (..., N, 2), N >= 4; unit
    Frobenius norm."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    x1n, T1 = _hartley_normalize(x1, mask)
    x2n, T2 = _hartley_normalize(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    # two rows per correspondence of A h = 0 (h = vec(H), row-major)
    r1 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([z, z, z, u1, v1, o, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([r1 * mask[..., None], r2 * mask[..., None]], dim=-2).double()
    AtA = A.transpose(-1, -2) @ A           # float64, as in epipolar.eight_point
    h = smallest_eigvec_psd(AtA.reshape(-1, 9, 9)).reshape(AtA.shape[:-2] + (9,)).to(x1.dtype)
    H = _inv3x3(T2) @ h.reshape(h.shape[:-1] + (3, 3)) @ T1
    nrm = torch.linalg.vector_norm(H.reshape(H.shape[:-2] + (9,)), dim=-1)
    return H / torch.clamp(nrm[..., None, None], min=1e-12)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], dim=-2)
    return adj / det[..., None, None]


def symmetric_transfer_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Squared symmetric transfer error per correspondence, (..., N)."""
    def transfer(Hm, a, b):
        p = torch.cat([a, torch.ones_like(a[..., :1])], dim=-1) @ Hm.transpose(-1, -2)
        z = p[..., 2:3]
        z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
        return ((p[..., :2] / z - b) ** 2).sum(-1)

    return transfer(H, x1, x2) + transfer(_inv3x3(H), x2, x1)


def homography_ransac(x1, x2, mask, thres_sq, num_hypotheses: int = 32,
                      u=None, generator=None):
    """Batched fixed-budget H-RANSAC over all pairs: returns (H [P,3,3],
    inliers [P,M], num_inliers [P]).

    x1, x2: [P, M, 2] (any consistent coordinate frame), mask [P, M] bool,
    thres_sq: [P] squared symmetric transfer threshold in that frame.
    u: optional injected draws [P, num_hypotheses, 4]; else drawn from
    `generator`.
    """
    P, M, _ = x1.shape
    S = num_hypotheses
    u = uniform_draws((P, S, 4), u, generator, x1.device)
    idx = sample_indices(u, mask)                                   # [P, S, 4]
    rows = torch.arange(P, device=x1.device)[:, None, None]
    H0 = dlt_homography(
        x1[rows, idx].reshape(P * S, 4, 2), x2[rows, idx].reshape(P * S, 4, 2),
        mask[rows, idx].to(x1.dtype).reshape(P * S, 4)).reshape(P, S, 3, 3)
    err = symmetric_transfer_error(H0, x1[:, None], x2[:, None])   # [P, S, M]
    inl = (err < thres_sq[:, None, None]) & mask[:, None]
    best = torch.argmax(inl.sum(-1), dim=-1)
    ar = torch.arange(P, device=x1.device)
    best_inl = inl[ar, best]
    H_best = H0[ar, best]
    # one masked LS refit on the winning consensus set
    H_refit = dlt_homography(x1, x2, best_inl.to(x1.dtype))
    inl_r = (symmetric_transfer_error(H_refit, x1, x2) < thres_sq[:, None]) & mask
    better = inl_r.sum(-1) >= best_inl.sum(-1)
    H_final = torch.where(better[:, None, None], H_refit, H_best)
    inl_final = torch.where(better[:, None], inl_r, best_inl)
    return H_final, inl_final, inl_final.sum(-1).to(torch.int32)
