"""Dense flow ops: forward/backward consistency, composition, the stride-2
composition fallback and motion boundaries (port of
particlesfm_tpu/ops/flow_ops.py).

Behavioral contract from upstream ParticleSfM's point_trajectory/utils.py:
- backward_warp: sample the backward flow map at pixel + forward flow (71-86);
- occlusion: err = ||warp(flow_b) + flow_f||, occluded if err > thres OR the
  target leaves the image (88-105, get_oob_mask at 60-68);
- motion_boundary: flow-gradient magnitude > thres * ||flow||
  (trajectory.py:39-43).
All ops take a stack [T, H, W, 2] (or one field [H, W, 2]).
"""
from __future__ import annotations

import torch

from .sampling import bilinear_sample, grid_coords


def _norm(v: torch.Tensor) -> torch.Tensor:
    # sqrt of the sum of squares, the expression jnp.linalg.norm evaluates
    return torch.sqrt((v * v).sum(-1))


def backward_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = img(p + flow(p)); img [..., H, W, C], flow [..., H, W, 2]."""
    H, W = flow.shape[-3:-1]
    coords = grid_coords(H, W, flow.dtype, flow.device) + flow
    return bilinear_sample(img, coords)


def out_of_bounds_mask(flow: torch.Tensor) -> torch.Tensor:
    """1.0 where pixel + flow leaves [0, W-1] x [0, H-1]."""
    H, W = flow.shape[-3:-1]
    target = grid_coords(H, W, flow.dtype, flow.device) + flow
    oob = (
        (target[..., 0] < 0)
        | (target[..., 0] > W - 1)
        | (target[..., 1] < 0)
        | (target[..., 1] > H - 1)
    )
    return oob.to(flow.dtype)


def occlusion_mask(flow_f: torch.Tensor, flow_b: torch.Tensor, thres: float):
    """Returns (occ [..., H, W] 0/1 float, err [..., H, W])."""
    err = _norm(backward_warp(flow_b, flow_f) + flow_f)
    occ = (err > thres).to(flow_f.dtype)
    occ = torch.clamp(occ + out_of_bounds_mask(flow_f), 0.0, 1.0)
    return occ, err


def flow_check(flows_f: torch.Tensor, flows_b: torch.Tensor, thres: float):
    """Occlusion check over [T, H, W, 2] stacks. Returns (occ [T,H,W], err)."""
    return occlusion_mask(flows_f, flows_b, thres)


def compose_flow(flow_ab: torch.Tensor, flow_bc: torch.Tensor):
    """Chain two flow fields: out(p) = flow_ab(p) + flow_bc(p + flow_ab(p)).

    Returns (composed [..., H, W, 2], valid [..., H, W] bool): valid is False
    where the intermediate lookup left the image. The lookup is the
    four-corner sample that fades to zero past the edge."""
    H, W = flow_ab.shape[-3:-1]
    mid = grid_coords(H, W, flow_ab.dtype, flow_ab.device) + flow_ab
    valid = ((mid[..., 0] >= 0) & (mid[..., 0] <= W - 1)
             & (mid[..., 1] >= 0) & (mid[..., 1] <= H - 1))
    return flow_ab + bilinear_sample(flow_bc, mid), valid


def stride2_compose_fallback(flow2: torch.Tensor, flow1_a: torch.Tensor,
                             flow1_b: torch.Tensor, disagree_px: float = 4.0):
    """Replace the net's stride-2 flow (pair i: i -> i+2) with the composition
    of its two stride-1 hops (i -> i+1, i+1 -> i+2) where the two disagree
    by more than `disagree_px` and the composition is defined.

    Returns (blended [N, H, W, 2], used [N, H, W] bool)."""
    comp, valid = compose_flow(flow1_a, flow1_b)
    use = (_norm(flow2 - comp) > disagree_px) & valid
    return torch.where(use[..., None], comp, flow2), use


def motion_boundary(flow: torch.Tensor, thres: float = 0.02) -> torch.Tensor:
    """Motion-boundary mask [H, W] of one field [H, W, 2]: forward-difference
    gradient magnitude against thres * ||flow||."""
    dx = torch.zeros_like(flow)
    dy = torch.zeros_like(flow)
    dx[:, :-1] = (flow[:, :-1] - flow[:, 1:]).abs()
    dy[:-1] = (flow[:-1] - flow[1:]).abs()
    grad = torch.sqrt(dx.mean(-1) ** 2 + dy.mean(-1) ** 2)
    return (grad > thres * _norm(flow)).to(flow.dtype)
