"""Batched homography estimation for planar-pair rejection
(port of particlesfm_tpu/geometry/homography.py).

4-point DLT through the same Hartley conditioning and 9x9 smallest
eigenvector (in float64) as the 8-point solver, the symmetric transfer
error, a fixed-budget H-RANSAC over all pairs in lockstep, and the Faugeras
decomposition of a calibrated homography.
"""
from __future__ import annotations

import torch

from ..globalsfm.twoview import sample_indices, uniform_draws
from .epipolar import _hartley_normalize, triangulate_midpoint_depths
from .linalg3 import smallest_eigvec_psd, svd3x3


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


def decompose_homography(H, x1, x2, mask=None):
    """Faugeras SVD decomposition of a calibrated homography (normalized camera
    coords): H ~ R + t n^T / d. Returns the cheirality-best (R [..., 3, 3],
    t [..., 3] unit-or-zero, n [..., 3]) and `t_mag`, the relative baseline
    magnitude (d1 - d3) / d2 (~0 for pure rotation: the PANORAMIC test).

    Four closed-form candidates (the d' > 0 sign choices) scored by the
    cheirality votes of the masked correspondences.
    """
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    U, S, Vt = svd3x3(H)
    V = Vt.transpose(-1, -2)
    s_uv = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    d2s = torch.where(d2.abs() < 1e-12, torch.full_like(d2, 1e-12), d2)
    den = torch.clamp(d1 ** 2 - d3 ** 2, min=1e-12)
    a1 = torch.sqrt(torch.clamp((d1 ** 2 - d2 ** 2) / den, min=0.0))
    a3 = torch.sqrt(torch.clamp((d2 ** 2 - d3 ** 2) / den, min=0.0))
    t_mag = (d1 - d3) / d2s

    def candidate(e1, e3):
        # d' > 0 branch of Faugeras: R' is a y-rotation
        sin_t = (d1 - d3) * e1 * e3 * a1 * a3 / d2s
        cos_t = (d1 * (a3 * e3) ** 2 + d3 * (a1 * e1) ** 2) / d2s
        nrm = torch.sqrt(torch.clamp(sin_t ** 2 + cos_t ** 2, min=1e-12))
        sin_t, cos_t = sin_t / nrm, cos_t / nrm
        z = torch.zeros_like(sin_t)
        o = torch.ones_like(sin_t)
        Rp = torch.stack([torch.stack([cos_t, z, -sin_t], -1),
                          torch.stack([z, o, z], -1),
                          torch.stack([sin_t, z, cos_t], -1)], dim=-2)
        tp = torch.stack([(d1 - d3) * a1 * e1, z, -(d1 - d3) * a3 * e3], dim=-1)
        npr = torch.stack([a1 * e1, z, a3 * e3], dim=-1)
        R = s_uv[..., None, None] * (U @ Rp @ V.transpose(-1, -2))
        t = (U @ tp[..., None])[..., 0]
        n = (V @ npr[..., None])[..., 0]
        # orient the plane normal toward camera 1 (n^T x > 0 for visible points)
        flip = torch.sign(n[..., 2:3] + 1e-12)
        return R, t * flip, n * flip

    cands = [candidate(e1, e3) for e1 in (1.0, -1.0) for e3 in (1.0, -1.0)]
    Rs = torch.stack([c[0] for c in cands], dim=0)
    ts = torch.stack([c[1] for c in cands], dim=0)
    ns = torch.stack([c[2] for c in cands], dim=0)

    def unit(t):
        return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)

    votes = []
    for c in range(4):
        dd1, dd2 = triangulate_midpoint_depths(Rs[c], unit(ts[c]), x1, x2)
        votes.append((((dd1 > 0) & (dd2 > 0)) * mask).sum(-1))
    best = torch.argmax(torch.stack(votes, dim=0), dim=0)

    def take(arr):
        idx = best[(None, ...) + (None,) * (arr.dim() - 1 - best.dim())]
        return torch.gather(arr, 0, idx.expand((1,) + arr.shape[1:]))[0]

    return take(Rs), unit(take(ts)), take(ns), t_mag
