"""Robust rotation averaging: Chatterjee-Govindu L1 then IRLS on the tangent
space (port of particlesfm_tpu/globalsfm/rotation_averaging.py).

Residual R_err = R_j^T R_ij R_i in angle-axis; each step solves the weighted
graph Laplacian (x) I_3 densely with 3 right-hand sides. The Laplacian and
its right-hand side are products with the dense edge-incidence matrix, so
the sums run in a fixed order on every device (no scatter-add).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import rotations as rot


def _incidence(num_views: int, edges: torch.Tensor, dtype) -> torch.Tensor:
    """B [E, V]: +1 at view i, -1 at view j of each edge (i, j)."""
    E = edges.shape[0]
    B = torch.zeros(E, num_views, dtype=dtype, device=edges.device)
    ar = torch.arange(E, device=edges.device)
    B[ar, edges[:, 0]] += 1.0
    B[ar, edges[:, 1]] -= 1.0
    return B


def _edge_residuals(R, R_rel, edges):
    """err_e = Log(R_j^T R_ij R_i) in angle-axis, [E, 3]."""
    M = R[edges[:, 1]].transpose(-1, -2) @ R_rel @ R[edges[:, 0]]
    return rot.rotmat_to_angle_axis(M)


def _solve_tangent_step(B, w, err):
    """min_delta sum_e w_e ||err_e + delta_i - delta_j||^2 with delta_0 = 0."""
    V = B.shape[1]
    L = B.T @ (w[:, None] * B)
    b = -(B.T @ (w[:, None] * err))
    L[0, :] = 0.0
    L[:, 0] = 0.0
    L[0, 0] = 1.0
    b[0] = 0.0
    L = L + 1e-8 * torch.eye(V, dtype=L.dtype, device=L.device)
    return torch.linalg.solve(L, b)


def average_rotations(num_views: int, edges: torch.Tensor, R_rel: torch.Tensor,
                      R_init: torch.Tensor, edge_mask: torch.Tensor,
                      l1_iters: int = 5, irls_iters: int = 30, sigma_deg: float = 5.0):
    """Returns (absolute rotations [V, 3, 3] world->cam with view 0 pinned,
    info dict of per-phase iteration counts and final edge residuals).

    edges [E, 2] int64 (i, j); R_rel [E, 3, 3] with R_j ~= R_ij R_i;
    edge_mask [E] 1.0 valid / 0.0 ignored. Both phases stop when the largest
    step falls to 1e-4 rad or at their iteration cap; the test reads the
    step back to the host once per iteration.
    """
    dt = R_init.dtype
    sigma = math.radians(sigma_deg)
    step_tol = float(np.float32(1e-4))   # the reference's float32 tolerance
    B = _incidence(num_views, edges, dt)

    def phase(R, weight_fn, max_iters):
        it, step = 0, float("inf")
        while step > step_tol and it < max_iters:
            err = _edge_residuals(R, R_rel, edges)
            delta = _solve_tangent_step(B, weight_fn(err), err)
            # float32 like the reference's carry, so the test sees its value
            step = float(torch.linalg.vector_norm(delta, dim=-1).max())
            R = R @ rot.angle_axis_to_rotmat(delta)
            it += 1
        return R, it, step

    def l1_weights(err):
        return edge_mask / torch.clamp(torch.linalg.vector_norm(err, dim=-1), min=1e-5)

    def irls_weights(err):
        e2 = (err * err).sum(-1)
        return edge_mask * (sigma * sigma) / torch.square(e2 + sigma * sigma)

    R, it_l1, _ = phase(R_init, l1_weights, l1_iters)
    R, it_irls, last_step = phase(R, irls_weights, irls_iters)
    e = torch.linalg.vector_norm(_edge_residuals(R, R_rel, edges), dim=-1)
    mean_err = (e * edge_mask).sum() / torch.clamp(edge_mask.sum(), min=1.0)
    e_valid = torch.where(edge_mask > 0, e, torch.full_like(e, float("inf")))
    k = int((edge_mask > 0).sum()) // 2
    med_err = torch.sort(e_valid)[0][k]
    info = {"l1_iters": it_l1, "irls_iters": it_irls, "last_step_rad": last_step,
            "mean_residual_rad": mean_err, "median_residual_rad": med_err}
    return rot.project_to_rotmat(R), info
