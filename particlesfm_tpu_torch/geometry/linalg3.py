"""Closed-form small-matrix factorizations
(port of particlesfm_tpu/geometry/linalg3.py).

Iterative eigensolvers run to their data-dependent worst case on the
near-singular matrices that SfM feeds them by design (8-point null vectors,
rank-2 fundamentals). These replacements (trigonometric symmetric 3x3
eigendecomposition, Cholesky inverse iteration for the smallest eigenvector)
run at a fixed cost, batched over any leading axes, on any device.
"""
from __future__ import annotations

import math

import torch


def _det3x3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion along the first row."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def eigh3x3_desc(A: torch.Tensor):
    """Analytic symmetric 3x3 eigendecomposition, eigenvalues DESCENDING.

    A: [..., 3, 3] symmetric. Returns (w [..., 3], V [..., 3, 3]) with
    A ~= V diag(w) V^T. Deterministic flops (no iteration).
    """
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * I
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = _det3x3(B) / torch.clamp(2.0 * p ** 3, min=1e-30)
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    w0 = q + 2.0 * p * torch.cos(phi)
    w2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)

    # Repeated eigenvalues are the common case (E^T E of an essential matrix
    # has s0 == s1 exactly): take the eigenvector of the best-separated
    # eigenvalue from the matrix product, then diagonalize the 2x2
    # restriction of A to its orthogonal complement in closed form.
    def sep_eigvec(wa, wb):
        """Unit eigenvector for the eigenvalue NOT in {wa, wb}."""
        M = (A - wa[..., None, None] * I) @ (A - wb[..., None, None] * I)
        best = torch.argmax(torch.linalg.vector_norm(M, dim=-2), dim=-1)
        v = torch.gather(M, -1, best[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return torch.where(n > 1e-30, v / torch.clamp(n, min=1e-30), I[0].expand_as(v))

    top_separated = (w0 - w1) >= (w1 - w2)
    v_sep = torch.where(top_separated[..., None], sep_eigvec(w1, w2), sep_eigvec(w0, w1))
    e = torch.where(v_sep[..., :1].abs() < 0.9, I[0].expand_as(v_sep), I[1].expand_as(v_sep))
    b1 = _unit(torch.linalg.cross(v_sep, e, dim=-1))
    b2 = torch.linalg.cross(v_sep, b1, dim=-1)
    Ab1 = (A @ b1[..., None])[..., 0]
    Ab2 = (A @ b2[..., None])[..., 0]
    a2 = (b1 * Ab1).sum(-1)
    b2c = (b1 * Ab2).sum(-1)
    c2 = (b2 * Ab2).sum(-1)
    theta = 0.5 * torch.atan2(2.0 * b2c, a2 - c2)
    ct, st = torch.cos(theta), torch.sin(theta)
    u_hi = ct[..., None] * b1 + st[..., None] * b2       # larger eigenvalue
    u_lo = -st[..., None] * b1 + ct[..., None] * b2
    lam_hi = a2 * ct * ct + 2 * b2c * ct * st + c2 * st * st
    lam_lo = a2 + c2 - lam_hi
    swap = (lam_lo > lam_hi)[..., None]
    u_hi, u_lo = torch.where(swap, u_lo, u_hi), torch.where(swap, u_hi, u_lo)
    ts = top_separated[..., None]
    v0 = torch.where(ts, v_sep, u_hi)
    v1 = torch.where(ts, u_hi, u_lo)
    v2 = torch.where(ts, u_lo, v_sep)
    return w, torch.stack([v0, v1, v2], dim=-1)


def svd3x3(E: torch.Tensor):
    """SVD of arbitrary 3x3 batches via analytic eigh of E^T E.

    Returns (U, s, Vt) with s descending and U, V proper for the top-2
    singular directions; the third left vector is u0 x u1 (adequate where
    s2 ~ 0). Deterministic flops.
    """
    I = torch.eye(3, dtype=E.dtype, device=E.device)
    w, V = eigh3x3_desc(E.transpose(-1, -2) @ E)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    Ev = E @ V                                      # columns E v_i
    u0 = Ev[..., :, 0]
    n0 = torch.linalg.vector_norm(u0, dim=-1, keepdim=True)
    u0 = torch.where(n0 > 1e-12, u0 / torch.clamp(n0, min=1e-30), I[0].expand_as(u0))
    u1 = Ev[..., :, 1]
    u1 = u1 - (u1 * u0).sum(-1, keepdim=True) * u0
    n1 = torch.linalg.vector_norm(u1, dim=-1, keepdim=True)
    alt = torch.linalg.cross(u0, I[0].expand_as(u0), dim=-1)
    altn = torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    alt = _unit(torch.where(altn > 1e-6, alt,
                            torch.linalg.cross(u0, I[1].expand_as(u0), dim=-1)))
    u1 = torch.where(n1 > 1e-6, u1 / torch.clamp(n1, min=1e-30), alt)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    return torch.stack([u0, u1, u2], dim=-1), s, V.transpose(-1, -2)


def smallest_eigvec_psd(A: torch.Tensor, num_iters: int = 16) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of PSD A [..., D, D].

    Shifted Cholesky inverse iteration: deterministic flops, robust on the
    near-singular normal matrices of minimal solvers. A matrix whose
    factorization fails yields NaN, as the reference's does. Accuracy ~1e-3
    in direction, ample for RANSAC hypotheses that are re-fit afterwards.
    """
    D = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = A + (1e-7 * tr + 1e-20) * torch.eye(D, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info != 0)[..., None, None], torch.nan, L)
    x = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(num_iters):
        y = torch.cholesky_solve(x[..., None], L)[..., 0]
        x = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-30)
    return x
