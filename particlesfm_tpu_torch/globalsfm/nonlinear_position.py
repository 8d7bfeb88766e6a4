"""1DSfM nonlinear position refinement (Wilson & Snavely, ECCV 2014)
(port of particlesfm_tpu/globalsfm/nonlinear_position.py).

Minimizes the robust chordal error between estimated baseline directions and
measured world pair directions,

    min_p  sum_e  rho( || (p_i - p_j)/||p_i - p_j||  -  w_e || )

by a fixed number of Levenberg-Marquardt steps over all positions jointly:
soft-L1 as IRLS weights, closed-form per-edge Jacobians, one dense
[3V, 3V] solve per step, p_0 pinned (the translation gauge).

The normal equations are sums over edges into their two views. They are
products with the signed edge-view incidence matrix, so every sum runs in a
fixed order on every device, and the accept test never sees an atomic
order. The steps run in float64: in float32 the accept test compares costs
that differ by their rounding near convergence, so the CPU and the card
took different steps. No step reads back to the host.
"""
from __future__ import annotations

import torch


def _residuals(p, edges, w_dir, scale_soft):
    d = p[edges[:, 0]] - p[edges[:, 1]]                # [E, 3]
    nrm = torch.sqrt((d * d).sum(-1, keepdim=True))
    u = d / torch.clamp(nrm, min=1e-9)
    r = u - w_dir
    r2 = (r * r).sum(-1)
    w = 1.0 / torch.sqrt(1.0 + r2 / (scale_soft * scale_soft))   # soft-L1 IRLS
    return r, u, nrm[..., 0], w


def refine_positions_nonlinear(
    num_views: int,
    edges: torch.Tensor,       # [E, 2] int
    w_dir: torch.Tensor,       # [E, 3] unit world directions p_i - p_j
    edge_mask: torch.Tensor,   # [E]
    p_init: torch.Tensor,      # [V, 3]
    max_iterations: int = 30,
    loss_scale: float = 0.1,
) -> torch.Tensor:
    V = num_views
    out_dtype, dev = p_init.dtype, w_dir.device
    dt = torch.float64
    w_dir = w_dir.to(dt)
    edges = edges.to(torch.int64)
    em = edge_mask.to(dt)
    oh = torch.nn.functional.one_hot(edges, V).to(dt)       # [E, 2, V]
    inc = oh[:, 0] - oh[:, 1]                                # [E, V] signed incidence
    pair_inc = (inc[:, :, None] * inc[:, None, :]).reshape(-1, V * V)   # [E, V*V]
    fvec = torch.ones(3 * V, dtype=dt, device=dev)
    fvec[:3] = 0.0                                           # pin p0 (translation)
    pin = torch.diag(1.0 - fvec)
    I3 = torch.eye(3, dtype=dt, device=dev)
    s2 = loss_scale * loss_scale

    def cost_of(p):
        r = _residuals(p, edges, w_dir, loss_scale)[0]
        r2 = (r * r).sum(-1)
        return (2.0 * s2 * (torch.sqrt(1.0 + r2 / s2) - 1.0) * em).sum()

    p = p_init.to(dt)
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(max_iterations):
        r, u, nrm, w = _residuals(p, edges, w_dir, loss_scale)
        w = w * em
        # d r / d d = (I - u u^T) / ||d||;  d d/d p_i = I, d d/d p_j = -I
        J = ((I3 - u[:, :, None] * u[:, None, :])
             / torch.clamp(nrm, min=1e-9)[:, None, None] * w[:, None, None])   # [E, 3, 3]
        rw = r * w[:, None]
        JtJ = (J[:, :, :, None] * J[:, :, None, :]).sum(1)   # [E, 3, 3]
        g = (J * rw[:, :, None]).sum(1)                      # [E, 3]
        H = (pair_inc.T @ JtJ.reshape(-1, 9)).reshape(V, V, 3, 3)
        b = -(inc.T @ g)                                     # [V, 3]
        Hf = H.permute(0, 2, 1, 3).reshape(3 * V, 3 * V)
        Hf = Hf + lam * torch.eye(3 * V, dtype=dt, device=dev)
        Hf = Hf * fvec[:, None] * fvec[None, :] + pin
        dp = torch.linalg.solve_ex(Hf, (b.reshape(-1) * fvec)[:, None])[0].reshape(V, 3)
        p_new = p + dp
        accept = cost_of(p_new) < cost_of(p)
        p = torch.where(accept, p_new, p)
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-10),
                          torch.clamp(lam * 3.0, max=1e6))
    return p.to(out_dtype)
