"""Photometric sub-pixel refinement of net-predicted optical flow
(port of particlesfm_tpu/flow/refine.py).

A few damped Lucas-Kanade Gauss-Newton iterations against the actual image
pair pull each flow vector to the photometric optimum wherever texture
supports it; a trust region keeps texture-poor regions at the net's flow.

Algorithm (forward-additive LK with Gaussian window aggregation):
  repeat `iters` times:
    r   = I2(x + u) - I1(x)                      (photometric residual)
    g   = grad I2 sampled at x + u
    w   = [|r| < robust_thresh] * in_bounds      (robust/occlusion weights)
    A   = G * [w g g^T] + damp I                 (G = Gaussian window filter)
    b   = -G * [w g r]
    du  = A^-1 b  (closed-form 2x2), per-iteration step clamp
    u   = clip_to_trust_region(u + du, u0, max_total)
  pixels whose window carries no signal keep their current estimate.
All functions work on a batch of pairs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.sampling import bilinear_sample, grid_coords


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] or [B, H, W] float in [0, 1] -> [B, H, W]."""
    if img.dim() == 3:
        return img
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _gaussian_kernel1d(sigma: float, radius: int, dtype, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _window_filter(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian window sum over the last two dims of x [B, K, H, W]
    (zero padding): one depthwise conv pair with groups=K."""
    K = x.shape[1]
    r = (k1d.shape[0] - 1) // 2
    kh = k1d.view(1, 1, -1, 1).expand(K, 1, -1, 1)
    kw = k1d.view(1, 1, 1, -1).expand(K, 1, 1, -1)
    y = F.conv2d(x, kh, padding=(r, 0), groups=K)
    return F.conv2d(y, kw, padding=(0, r), groups=K)


def _gradients(img: torch.Tensor):
    """Central-difference gradients of [B, H, W] with zero borders -> (gx, gy)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., :, 1:-1] = 0.5 * (img[..., :, 2:] - img[..., :, :-2])
    gy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return gx, gy


def photometric_refine(
    img1s: torch.Tensor,          # [B, H, W, 3] or [B, H, W] float in [0, 1]
    img2s: torch.Tensor,
    flows: torch.Tensor,          # [B, H, W, 2] initial flow
    iters: int = 4,
    anchors: torch.Tensor = None,  # [B, H, W, 2] trust-region center (default flows)
    window_sigma: float = 2.0,
    window_radius: int = 4,
    damp: float = 1e-4,
    step_clamp: float = 1.0,
    max_total: float = 3.0,
    robust_thresh: float = 0.25,
    min_weight: float = 0.05,
) -> torch.Tensor:
    """Refine a batch of pairs' flow fields (refine.py:87,160). Returns [B, H, W, 2]."""
    dtype = flows.dtype
    if anchors is None:
        anchors = flows
    I1 = _grayscale(img1s).to(dtype)
    I2 = _grayscale(img2s).to(dtype)
    B, H, W = I1.shape
    gx2, gy2 = _gradients(I2)
    I2s = torch.stack([I2, gx2, gy2], dim=-1)              # one 3-channel gather
    k1d = _gaussian_kernel1d(window_sigma, window_radius, dtype, flows.device)
    grid = grid_coords(H, W, dtype, flows.device)

    u = flows
    for _ in range(iters):
        pos = grid + u                                     # [B, H, W, 2]
        wrp = bilinear_sample(I2s, pos.reshape(B, -1, 2)).reshape(B, H, W, 3)
        I2w, gxw, gyw = wrp[..., 0], wrp[..., 1], wrp[..., 2]
        r = I2w - I1
        inb = (
            (pos[..., 0] >= 1.0) & (pos[..., 0] <= W - 2.0)
            & (pos[..., 1] >= 1.0) & (pos[..., 1] <= H - 2.0)
        )
        wf = ((r.abs() < robust_thresh) & inb).to(dtype)
        fields = torch.stack(
            [wf * gxw * gxw, wf * gxw * gyw, wf * gyw * gyw,
             wf * gxw * r, wf * gyw * r, wf], dim=1)       # [B, 6, H, W]
        fA11, fA12, fA22, fb1, fb2, wsum = _window_filter(fields, k1d).unbind(1)
        A11 = fA11 + damp
        A12 = fA12
        A22 = fA22 + damp
        b1 = -fb1
        b2 = -fb2
        det = A11 * A22 - A12 * A12
        du = torch.stack(
            [(A22 * b1 - A12 * b2), (A11 * b2 - A12 * b1)], dim=-1
        ) / torch.clamp(det, min=1e-12)[..., None]
        du = torch.clamp(du, -step_clamp, step_clamp)
        ok = (wsum > min_weight) & (det > 1e-9) & inb
        u_new = u + torch.where(ok[..., None], du, torch.zeros_like(du))
        d = u_new - anchors
        n = torch.sqrt((d * d).sum(-1, keepdim=True))
        scale = torch.clamp(max_total / torch.clamp(n, min=1e-9), max=1.0)
        u = anchors + d * scale
    return u


def photometric_refine_pair(img1, img2, flow0, anchor=None, **kwargs):
    """One pair: img [H, W, 3] or [H, W], flow0 [H, W, 2] -> [H, W, 2]."""
    anchors = None if anchor is None else anchor[None]
    return photometric_refine(img1[None], img2[None], flow0[None],
                              anchors=anchors, **kwargs)[0]


DEFAULT_SCHEDULE = ((2, 3.5, 7), (3, 1.5, 3))


def photometric_refine_scheduled(img1s, img2s, flows, schedule=DEFAULT_SCHEDULE, **kwargs):
    """Window-annealed refinement: one GN pass per (iters, sigma, radius)
    phase, every phase anchored at the net's flow (refine.py:182)."""
    u = flows
    for iters, sigma, radius in schedule:
        u = photometric_refine(
            img1s, img2s, u, anchors=flows, iters=int(iters),
            window_sigma=float(sigma), window_radius=int(radius), **kwargs)
    return u
