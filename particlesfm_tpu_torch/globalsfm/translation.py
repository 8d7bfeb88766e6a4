"""Translation estimation: pairwise refinement with known rotations + LUD
position averaging (port of particlesfm_tpu/globalsfm/translation.py).

Pairwise refinement: per pair, the world baseline direction w (p_i - p_j)
satisfies (f1w x f2w) . w = 0 for every correspondence; IRLS minimizes
sum |a_m . w| over ||w|| = 1 by the null vector of the weighted 3x3 scatter
matrix, and a cheirality majority vote fixes its sign. All pairs run in
lockstep.

Positions: the constrained L1 program of LUD with per-triplet baseline-ratio
scale constraints,

    min sum_e || p_i - p_j - s_e w_e ||_1  +  sum_t w_t | ratio s_a - s_b |_1
    s.t. s_e >= 1  (view 0 pinned at the origin),

by ADMM. The operator A is assembled once as a dense matrix (each row holds
at most three entries), so every product sums in a fixed order on every
device; the z-update matrix A^T A + G^T G is Cholesky-factored once.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import epipolar
from ..geometry.linalg3 import eigh3x3_desc


def refine_pairwise_translations(edges, R_abs, x1, x2, mask, w_init, num_iters: int = 64):
    """Refined unit world-frame baseline directions w_e ~ p_i - p_j, [E, 3].

    edges [E, 2]; R_abs [V, 3, 3] world->cam; x1, x2 [E, M, 2] normalized
    coords; mask [E, M] bool; w_init [E, 3]."""
    Ri = R_abs[edges[:, 0]]
    Rj = R_abs[edges[:, 1]]
    ones = torch.ones_like(x1[..., :1])
    f1w = torch.cat([x1, ones], -1) @ Ri                   # R_i^T x per point
    f2w = torch.cat([x2, ones], -1) @ Rj
    a = torch.linalg.cross(f1w, f2w, dim=-1)               # [E, M, 3]
    m = mask.to(x1.dtype)
    w = w_init
    for _ in range(num_iters):
        e = (a @ w[..., None])[..., 0].abs()
        wgt = m / torch.clamp(e, min=1e-7)
        C = (a * wgt[..., None]).transpose(-1, -2) @ a
        _, evecs = eigh3x3_desc(C)
        w = evecs[..., :, 2]
    # cheirality: with t_ij = R_j w, do most matches triangulate in front?
    Rij = Rj @ Ri.transpose(-1, -2)
    t_ij = (Rj @ w[..., None])[..., 0]
    d1, d2 = epipolar.triangulate_midpoint_depths(Rij, t_ij, x1, x2)
    front = (((d1 > 0) & (d2 > 0)) * m).sum(-1)
    total = torch.clamp(m.sum(-1), min=1.0)
    return torch.where((front > 0.5 * total)[:, None], w, -w)


def directions_from_relative_poses(edges, R_abs, t_rel):
    """World baseline directions from two-view translations: w = R_j^T t_ij."""
    w = (R_abs[edges[:, 1]].transpose(-1, -2) @ t_rel[..., None])[..., 0]
    return w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-12)


class TripletConstraints(NamedTuple):
    """Baseline-ratio scale constraints: 3 rows per triplet over scale variables.

    edge_idx [T, 3]: indices into the edge list of pairs (ij, ik, jk);
    ratios [T, 3]: triangulated baselines (b_ij, b_ik, b_jk) within the triplet;
    weight [T]: confidence, 0 disables a row group.
    """
    edge_idx: torch.Tensor
    ratios: torch.Tensor
    weight: torch.Tensor

    @staticmethod
    def empty(device="cpu"):
        return TripletConstraints(
            edge_idx=torch.zeros((0, 3), dtype=torch.int64, device=device),
            ratios=torch.ones((0, 3), dtype=torch.float32, device=device),
            weight=torch.zeros((0,), dtype=torch.float32, device=device))


def _lud_operator(num_views: int, edges, w_dir, edge_mask, trip: TripletConstraints):
    """The dense LUD operator A [(3E + 3T), 3V + E] over z = (p, s): pair rows
    (p_i - p_j - s_e w_e) * mask_e with p_0's columns zero (the gauge), then
    the three scale rows of each triplet."""
    V, E, T = num_views, edges.shape[0], trip.edge_idx.shape[0]
    dt, dev = w_dir.dtype, w_dir.device
    D = 3 * V + E
    A = torch.zeros(3 * E + 3 * T, D, dtype=dt, device=dev)
    ar = torch.arange(E, device=dev)
    em = edge_mask
    for c in range(3):
        rows = 3 * ar + c
        A[rows, 3 * edges[:, 0] + c] += em
        A[rows, 3 * edges[:, 1] + c] -= em
        A[rows, 3 * V + ar] = -w_dir[:, c] * em
    A[:, :3] = 0.0
    e12, e13, e23 = trip.edge_idx.unbind(-1)
    b12, b13, b23 = trip.ratios.unbind(-1)
    tw = trip.weight
    r12 = b13 / torch.clamp(b12, min=1e-12)
    r13 = b23 / torch.clamp(b12, min=1e-12)
    r23 = b23 / torch.clamp(b13, min=1e-12)
    at = torch.arange(T, device=dev)
    base = 3 * E + 3 * at
    for k, (ea, ra, eb) in enumerate(((e12, r12, e13), (e12, r13, e23), (e13, r23, e23))):
        A[base + k, 3 * V + ea] += tw * ra
        A[base + k, 3 * V + eb] -= tw
    return A


def estimate_positions_lud(num_views: int, edges, w_dir, edge_mask,
                           triplets: TripletConstraints | None = None,
                           admm_iters: int = 2000, rho: float = 1.0):
    """Camera positions [V, 3] (view 0 at the origin), per-edge scales [E] and
    an info dict, by ADMM on min ||A z||_1 s.t. s >= 1 (splitting y1 = A z,
    soft-thresholded, and y2 = s, projected onto s >= 1).

    Stops when the primal residual ||Az - y|| and the dual residual
    rho ||A^T (y - y_prev)|| both fall below 1e-4 sqrt(3E + 3T) + 1e-4 ||Az, s||
    (read back once per iteration), or after `admm_iters` iterations.
    """
    dt, dev = w_dir.dtype, w_dir.device
    trip = triplets if triplets is not None else TripletConstraints.empty(dev)
    V, E, T = num_views, edges.shape[0], trip.edge_idx.shape[0]
    D = 3 * V + E
    A = _lud_operator(V, edges, w_dir, edge_mask, trip)
    G = torch.zeros(E, D, dtype=dt, device=dev)
    G[torch.arange(E, device=dev), 3 * V + torch.arange(E, device=dev)] = 1.0
    gauge = torch.cat([torch.zeros(3, dtype=dt, device=dev), torch.ones(D - 3, dtype=dt, device=dev)])
    M = A.T @ A + G.T @ G
    M = M * gauge[:, None] * gauge[None, :] + torch.diag(1.0 - gauge)
    M = M + 1e-8 * torch.eye(D, dtype=dt, device=dev)
    L = torch.linalg.cholesky(M)

    kappa = 1.0 / rho
    tol_abs = tol_rel = float(np.float32(1e-4))
    tol0 = tol_abs * float(np.float32(math.sqrt(float(3 * E + 3 * T))))
    nP = 3 * E

    def soft(v):
        return torch.sign(v) * torch.clamp(v.abs() - kappa, min=0.0)

    z = torch.cat([torch.zeros(3 * V, dtype=dt, device=dev), torch.ones(E, dtype=dt, device=dev)])
    y1 = torch.zeros(3 * E + 3 * T, dtype=dt, device=dev)
    u1 = torch.zeros_like(y1)
    y2 = torch.ones(E, dtype=dt, device=dev)
    u2 = torch.zeros(E, dtype=dt, device=dev)
    it, r_pri, r_dual = 0, float("inf"), float("inf")
    while it < admm_iters:
        rhs = A.T @ (y1 - u1) + G.T @ (y2 - u2)
        z = torch.cholesky_solve((rhs * gauge)[:, None], L)[:, 0]
        Az = A @ z
        sv = z[3 * V:]
        y1_n = soft(Az + u1)
        y2_n = torch.maximum(sv + u2, torch.ones_like(sv))
        u1 = u1 + Az - y1_n
        u2 = u2 + sv - y2_n
        rp = torch.sqrt(((Az - y1_n) ** 2).sum() + ((sv - y2_n) ** 2).sum())
        dz = A.T @ (y1_n - y1) + G.T @ (y2_n - y2)
        rd = rho * torch.sqrt((dz * dz).sum())
        scale_ref = torch.sqrt((Az ** 2).sum() + (sv ** 2).sum())
        tol = tol0 + tol_rel * scale_ref
        y1, y2 = y1_n, y2_n
        it += 1
        stats = torch.stack([rp, rd, tol]).cpu()
        r_pri, r_dual = float(stats[0]), float(stats[1])
        if bool((stats[0] < stats[2]) & (stats[1] < stats[2])):
            break
    pv = z[:3 * V].reshape(V, 3).clone()
    pv[0] = 0.0
    info = {"iters": it, "r_primal": r_pri, "r_dual": r_dual}
    return pv, z[3 * V:], info
