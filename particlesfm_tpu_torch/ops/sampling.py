"""Bilinear sampling at pixel coordinates (port of particlesfm_tpu/ops/sampling.py).

Semantics match torch.nn.functional.grid_sample(align_corners=True, zero
padding) at pixel-coordinate call sites, but the sample is the explicit
four-corner gather: coordinates stay in pixel units (grid_sample renormalizes
to [-1, 1], which costs sub-pixel precision at a width of 1024), every corner
is clipped into the image and carries its own validity mask.
"""
from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor, zero_pad: bool = True) -> torch.Tensor:
    """Sample img at pixel coords xy (x, y).

    img [H, W, C] with xy [..., 2] -> [..., C]; or batched img [B, H, W, C]
    with xy [B, ..., 2] -> [B, ..., C] (each batch entry samples its own image).
    With zero_pad=True, corners outside the image contribute zero, like
    grid_sample's default zero padding.
    """
    H, W, C = img.shape[-3:]
    flat = img.reshape(-1, C)
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    base = 0
    if img.dim() == 4:
        B = img.shape[0]
        base = (torch.arange(B, device=img.device) * (H * W)).view(
            (B,) + (1,) * (xy.dim() - 2))

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        if zero_pad:
            v = v * valid[..., None].to(img.dtype)
        return v

    w00 = ((1 - dx) * (1 - dy))[..., None]
    w01 = (dx * (1 - dy))[..., None]
    w10 = ((1 - dx) * dy)[..., None]
    w11 = (dx * dy)[..., None]
    return (
        w00 * gather(y0i, x0i)
        + w01 * gather(y0i, x0i + 1)
        + w10 * gather(y0i + 1, x0i)
        + w11 * gather(y0i + 1, x0i + 1)
    )


def bilinear_sample_nchw(img: torch.Tensor, xy: torch.Tensor,
                         zero_pad: bool = True) -> torch.Tensor:
    """Sample img [C, H, W] at pixel coords xy [N, 2] -> [N, C]."""
    return bilinear_sample(torch.movedim(img, 0, -1), xy, zero_pad=zero_pad)


def grid_coords(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel coordinate grid [H, W, 2] with (x, y) channels."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1)
