"""Linear (spectral) position estimation from triplet baseline ratios
(port of particlesfm_tpu/globalsfm/linear_position.py).

Jiang et al., "A Global Linear Method for Camera Pose Registration" (ICCV
2013): within a triplet (i, j, k) with world pair directions u = w_ij,
v = w_ik, w = w_jk and baseline ratios r_ik = b_ik / b_ij, r_jk = b_jk / b_ij,

    (p_i - p_k) - r_ik * v u^T (p_i - p_j) = 0
    (p_j - p_k) - r_jk * w u^T (p_i - p_j) = 0

(directions follow w_e ~ p_first - p_second). Positions are the smallest
eigenvector of A^T A with the uniform-translation nullspace projected out;
the sign follows the majority of the pair directions.

A^T A is the Gram matrix of the stacked row blocks, which are placed into
their views' columns by one-hot products, so it sums in a fixed order on
every device. It is formed and decomposed in float64: the eigenvector of a
144-square float32 matrix moves with the eigen solver's rounding, and LAPACK
(CPU) and cuSOLVER (card) round differently.
"""
from __future__ import annotations

import torch

from .translation import TripletConstraints


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of a 1-D tensor: the mean of the two middle values."""
    s = torch.sort(x)[0]
    n = x.numel()
    return 0.5 * s[(n - 1) // 2] + 0.5 * s[n // 2]


def estimate_positions_linear(
    num_views: int,
    edges: torch.Tensor,           # [E, 2] int (i, j), direction w ~ p_i - p_j
    w_dir: torch.Tensor,           # [E, 3]
    triplet_views: torch.Tensor,   # [T, 3] int (i, j, k)
    trip: TripletConstraints,      # edge_idx (ij, ik, jk) + ratios + weights
) -> torch.Tensor:
    """Positions [V, 3]: view 0 at the origin, unit median distance from it,
    sign-corrected. Triplets of weight 0 add nothing."""
    V = num_views
    dt, dev = torch.float64, w_dir.device
    wd = w_dir.to(dt)
    u = wd[trip.edge_idx[:, 0]]                       # w_ij ~ p_i - p_j
    v = wd[trip.edge_idx[:, 1]]                       # w_ik ~ p_i - p_k
    w = wd[trip.edge_idx[:, 2]]                       # w_jk ~ p_j - p_k
    ratios = trip.ratios.to(dt)
    b12 = torch.clamp(ratios[:, 0], min=1e-12)
    r_ik = ratios[:, 1] / b12
    r_jk = ratios[:, 2] / b12
    tw = torch.sqrt(torch.clamp(trip.weight.to(dt), min=0.0))[:, None, None]

    I3 = torch.eye(3, dtype=dt, device=dev)
    # row set A over (i, j, k): (p_i - p_k) - r_ik v u^T (p_i - p_j)
    M_A = r_ik[:, None, None] * v[:, :, None] * u[:, None, :]
    # row set B over (i, j, k): (p_j - p_k) - r_jk w u^T (p_i - p_j)
    M_B = r_jk[:, None, None] * w[:, :, None] * u[:, None, :]
    blocks = torch.stack([
        torch.stack([(I3 - M_A) * tw, M_A * tw, -I3 * tw], 1),
        torch.stack([-M_B * tw, (I3 + M_B) * tw, -I3 * tw], 1),
    ], 1)                                             # [T, set, view slot, 3, 3]
    oh = torch.nn.functional.one_hot(triplet_views.to(torch.int64), V).to(dt)   # [T, 3, V]
    # rows[t, s, r, v, c]: the triplet's 3 rows of set s in view v's columns
    rows = (oh[:, None, :, None, :, None] * blocks[:, :, :, :, None, :]).sum(2)
    Amat = rows.reshape(-1, 3 * V)
    Hf = Amat.T @ Amat

    # project out the 3-dim uniform-translation nullspace: (1_V (x) I3)/sqrt(V)
    Tn = I3.repeat(V, 1) / V ** 0.5                   # [3V, 3]
    TT = Tn @ Tn.T
    P = torch.eye(3 * V, dtype=dt, device=dev) - TT
    Hp = P @ Hf @ P + (torch.trace(Hf) + 1.0) * TT
    p = torch.linalg.eigh(Hp)[1][:, 0].reshape(V, 3)
    # sign: majority agreement with the measured pair directions
    d = p[edges[:, 0]] - p[edges[:, 1]]
    if float((d * wd).sum()) < 0:
        p = -p
    p = p - p[0]
    scale = _median(torch.linalg.vector_norm(p[1:], dim=-1))
    p = p / (1.0 if float(scale) < 1e-12 else scale)
    return p.to(w_dir.dtype)
