"""GLOMAP-style global positioning: joint camera-position + 3D-point solve
(port of particlesfm_tpu/globalsfm/global_positioning.py).

With rotations fixed, camera positions p_v and points X_n are solved
jointly from bearing constraints with auxiliary per-observation depths d_o,

    r_o = X_n - p_v - d_o * ray_o,

by IRLS block-coordinate iterations with exact sub-solves: the d-step in
closed form; the (p, X)-step by eliminating points (their Hessian blocks are
w I_3) into a scalar graph-Laplacian camera system [V, V] solved densely;
the scale gauge removed by renormalizing the mean depth to 1. Per-camera
sums are one-hot products (ops/segment.py). The reference draws a random
(p, X) and overwrites both with the first unit-weight (p, X)-step before
reading them, so the port starts from that step and takes no key.
"""
from __future__ import annotations

import torch

from ..ops.segment import row_segment_sum, segment_sum


def _solve_pX(V, fidx, w, c):
    """Exact weighted LS over (p, X) given the offsets c = d * ray [N, K, 3]:
    point elimination + the scalar Laplacian camera solve (camera 0 pinned)."""
    N, K = fidx.shape
    dt, dev = c.dtype, c.device
    Wn = torch.clamp(w.sum(1), min=1e-12)
    A = row_segment_sum(fidx, w, V)                                  # [N, V]
    S = torch.diag(A.sum(0)) - (A / Wn[:, None]).T @ A
    swc = (w[..., None] * c).sum(1)
    b = -segment_sum(fidx.reshape(N * K), (w[..., None] * c).reshape(N * K, 3), V)
    b = b + (A / Wn[:, None]).T @ swc
    S[0, :] = 0.0
    S[:, 0] = 0.0
    S[0, 0] = 1.0
    b[0] = 0.0
    S = S + 1e-9 * torch.eye(V, dtype=dt, device=dev)
    p = torch.linalg.solve(S, b)
    X = (w[..., None] * (p[fidx] + c)).sum(1) / Wn[:, None]
    return p, X


def _mean_depth(d, m):
    s = (d * m).sum() / torch.clamp(m.sum(), min=1.0)
    return torch.where(s < 1e-9, torch.ones_like(s), s)


def global_positioning(num_views, rays, fidx, mask, iters: int = 48, irls_eps: float = 1e-3):
    """rays [N, K, 3] unit world-frame bearings, fidx [N, K] camera index,
    mask [N, K] bool. Returns (positions [V, 3], points [N, 3], depths [N, K])."""
    m = mask.to(rays.dtype)
    d = torch.ones(fidx.shape, dtype=rays.dtype, device=rays.device)
    p, X = _solve_pX(num_views, fidx, m, d[..., None] * rays)      # first pass with unit weights
    d = torch.clamp(((X[:, None, :] - p[fidx]) * rays).sum(-1), min=1e-4)
    s = _mean_depth(d, m)
    p, X, d = p / s, X / s, d / s
    for _ in range(iters):
        r = X[:, None, :] - p[fidx] - d[..., None] * rays
        w = m / torch.clamp(torch.linalg.vector_norm(r, dim=-1), min=irls_eps)
        p, X = _solve_pX(num_views, fidx, w, d[..., None] * rays)
        d = torch.clamp(((X[:, None, :] - p[fidx]) * rays).sum(-1), min=1e-4)
        s = _mean_depth(d, m)
        p, X, d = p / s, X / s, d / s
    return p, X, d


def global_positioning_joint_focal(num_views, a, b, fidx, mask, g0: float = 1e-3,
                                   iters: int = 48, irls_eps: float = 1e-3):
    """Global positioning with a joint closed-form focal update.

    The bearing is parametrized in inverse focal g = 1/f: ray_o(g) = g a_o + b_o
    with a = R_v^T [(u - cx), (v - cy), 0] and b = R_v^T e_z, so with (p, X, d)
    fixed, g = sum w d a.(X - p - d b) / sum w d^2 ||a||^2 exactly. Returns (positions [V, 3], points [N, 3],
    depths [N, K], focal = 1/g)."""
    V = num_views
    m = mask.to(a.dtype)
    g = torch.tensor(g0, dtype=a.dtype, device=a.device)
    d = torch.ones(fidx.shape, dtype=a.dtype, device=a.device)
    p, X = _solve_pX(V, fidx, m, d[..., None] * (g * a + b))
    ray = g * a + b
    rr = (ray * ray).sum(-1)
    d = torch.clamp(((X[:, None, :] - p[fidx]) * ray).sum(-1) / torch.clamp(rr, min=1e-12),
                    min=1e-4)
    s = _mean_depth(d, m)
    p, X, d = p / s, X / s, d / s
    for _ in range(iters):
        ray = g * a + b
        r = X[:, None, :] - p[fidx] - d[..., None] * ray
        w = m / torch.clamp(torch.linalg.vector_norm(r, dim=-1), min=irls_eps)
        p, X = _solve_pX(V, fidx, w, d[..., None] * ray)
        # focal step: scalar WLS over g with (p, X, d) fixed
        dpx = X[:, None, :] - p[fidx]
        num = (w * d * (a * (dpx - d[..., None] * b)).sum(-1)).sum()
        den = (w * d * d * (a * a).sum(-1)).sum()
        g = torch.clamp(num / torch.clamp(den, min=1e-12), 1e-5, 1.0)
        ray = g * a + b
        rr = (ray * ray).sum(-1)
        d = torch.clamp((dpx * ray).sum(-1) / torch.clamp(rr, min=1e-12), min=1e-4)
        s = _mean_depth(d, m)
        p, X, d = p / s, X / s, d / s
    return p, X, d, 1.0 / g
