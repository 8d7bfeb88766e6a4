"""Triplet baseline-ratio estimation for similarity-constrained translation
averaging (port of particlesfm_tpu/globalsfm/triplets.py).

For each pair (a, b) of a triplet, camera a sits at the origin and camera b
at -w_ab (unit baseline along the estimated world direction of p_a - p_b);
each common point is two-ray triangulated and its depth read from each
camera. Ratios of unit-baseline depths of the same point from the same
camera across two pairs give the inverse baseline ratio; they are
aggregated by a masked median with a minimum triangulation angle. All
triplets run in one batch.
"""
from __future__ import annotations

import math

import torch

from .translation import TripletConstraints


def _masked_median(x, mask):
    """Upper median of masked entries per row (1.0 for an empty row)."""
    sorted_x = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1)[0]
    count = mask.sum(-1)
    mid = torch.clamp(count // 2, 0, x.shape[-1] - 1)
    val = torch.gather(sorted_x, -1, mid[..., None])[..., 0]
    return torch.where(count > 0, val, torch.ones_like(val))


def _unit_baseline_depths(r_a, r_b, p_b, min_angle_rad):
    """Two-ray depths with camera a at the origin and camera b at p_b.
    r_a, r_b: [T, Q, 3] unit world rays, p_b [T, 3]."""
    c = (r_a * r_b).sum(-1)
    denom = torch.clamp(1.0 - c * c, min=1e-12)
    pa = (r_a * p_b[:, None]).sum(-1)
    pb = (r_b * p_b[:, None]).sum(-1)
    la = (pa - c * pb) / denom
    lb = (c * pa - pb) / denom
    ang = torch.arccos(torch.clamp(c.abs(), -1.0, 1.0))
    return la, lb, (la > 1e-6) & (lb > 1e-6) & (ang >= min_angle_rad)


def triplet_baseline_constraints(R_abs, w_dir, triplet_views, triplet_edges,
                                 x_i, x_j, x_k, mask, min_angle_deg: float = 2.0,
                                 max_points: int = 100) -> TripletConstraints:
    """R_abs [V, 3, 3]; w_dir [E, 3] unit world directions per edge;
    triplet_views [T, 3] image indices (i, j, k); triplet_edges [T, 3] edge
    indices (ij, ik, jk); x_* [T, Q, 2] normalized coords of the common
    points; mask [T, Q] bool."""
    min_rad = math.radians(min_angle_deg)

    def world_rays(R, x):
        r = torch.cat([x, torch.ones_like(x[..., :1])], -1) @ R
        return r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-12)

    ri = world_rays(R_abs[triplet_views[:, 0]], x_i)
    rj = world_rays(R_abs[triplet_views[:, 1]], x_j)
    rk = world_rays(R_abs[triplet_views[:, 2]], x_k)
    wij, wik, wjk = (w_dir[triplet_edges[:, c]] for c in range(3))
    dij_i, dij_j, v_ij = _unit_baseline_depths(ri, rj, -wij, min_rad)
    dik_i, _, v_ik = _unit_baseline_depths(ri, rk, -wik, min_rad)
    djk_j, _, v_jk = _unit_baseline_depths(rj, rk, -wjk, min_rad)
    ok_ik = mask & v_ij & v_ik
    ok_jk = mask & v_ij & v_jk
    b_ik = _masked_median(dij_i / torch.clamp(dik_i, min=1e-12), ok_ik)
    b_jk = _masked_median(dij_j / torch.clamp(djk_j, min=1e-12), ok_jk)
    count = torch.minimum(ok_ik.sum(-1), ok_jk.sum(-1))
    weight = torch.clamp(count.to(x_i.dtype) / float(max_points), max=1.0)
    weight = torch.where(count >= 3, weight, torch.zeros_like(weight))
    ratios = torch.stack([torch.ones_like(b_ik), b_ik, b_jk], dim=-1)
    return TripletConstraints(edge_idx=triplet_edges, ratios=ratios, weight=weight)
