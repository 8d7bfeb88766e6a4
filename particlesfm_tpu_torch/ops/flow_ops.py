"""Forward/backward flow consistency (port of particlesfm_tpu/ops/flow_ops.py:20-51).

Behavioral contract from upstream ParticleSfM's point_trajectory/utils.py:
- backward_warp: sample the backward flow map at pixel + forward flow (71-86);
- occlusion: err = ||warp(flow_b) + flow_f||, occluded if err > thres OR the
  target leaves the image (88-105, get_oob_mask at 60-68).
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
