"""COLMAP-compatible camera models, batched
(port of particlesfm_tpu/geometry/cameras.py).

Parameters ride as a fixed-width canonical row (fx, fy, cx, cy, k) plus an
integer model id: SIMPLE_PINHOLE (f, cx, cy), PINHOLE (fx, fy, cx, cy),
SIMPLE_RADIAL (f, cx, cy, k).
"""
from __future__ import annotations

import torch

SIMPLE_PINHOLE = 0
PINHOLE = 1
SIMPLE_RADIAL = 2

MODEL_NAMES = {SIMPLE_PINHOLE: "SIMPLE_PINHOLE", PINHOLE: "PINHOLE", SIMPLE_RADIAL: "SIMPLE_RADIAL"}
MODEL_IDS = {v: k for k, v in MODEL_NAMES.items()}
NUM_PARAMS = {SIMPLE_PINHOLE: 3, PINHOLE: 4, SIMPLE_RADIAL: 4}


def pack_params(model: int, raw) -> torch.Tensor:
    """Pack a COLMAP param list into the canonical row (fx, fy, cx, cy, k)."""
    raw = torch.as_tensor(raw, dtype=torch.float32)
    z = torch.zeros_like(raw[:1])
    if model == SIMPLE_PINHOLE:
        return torch.cat([raw[:1], raw[:1], raw[1:3], z])
    if model == PINHOLE:
        return torch.cat([raw[:4], z])
    if model == SIMPLE_RADIAL:
        return torch.cat([raw[:1], raw[:1], raw[1:4]])
    raise ValueError(f"unknown camera model {model}")


def unpack_params(model: int, packed) -> list:
    p = [float(x) for x in packed]
    if model == SIMPLE_PINHOLE:
        return [p[0], p[2], p[3]]
    if model == PINHOLE:
        return p[:4]
    if model == SIMPLE_RADIAL:
        return [p[0], p[2], p[3], p[4]]
    raise ValueError(f"unknown camera model {model}")


def cam_to_img(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Normalized camera coords (..., 2) -> pixels (..., 2)."""
    fx, fy, cx, cy, k = params.unbind(-1)
    d = 1.0 + k * (xy * xy).sum(-1)
    return torch.stack([fx * xy[..., 0] * d + cx, fy * xy[..., 1] * d + cy], dim=-1)


def img_to_cam(params: torch.Tensor, uv: torch.Tensor, num_iters: int = 5) -> torch.Tensor:
    """Pixels -> normalized camera coords; fixed-point undistortion for SIMPLE_RADIAL."""
    fx, fy, cx, cy, k = params.unbind(-1)
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xu = xd
    for _ in range(num_iters):
        xu = xd / (1.0 + k[..., None] * (xu * xu).sum(-1, keepdim=True))
    return xu


def project(params: torch.Tensor, x_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> pixels (..., 2). No cheirality masking."""
    z = x_cam[..., 2:3]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return cam_to_img(params, x_cam[..., :2] / z)


def make_default_params(height: int, width: int, focal_factor: float = 1.2) -> torch.Tensor:
    """COLMAP's default prior: f = focal_factor * max(h, w), principal point at center."""
    f = focal_factor * max(height, width)
    return torch.tensor([f, f, width / 2.0, height / 2.0, 0.0], dtype=torch.float32)
