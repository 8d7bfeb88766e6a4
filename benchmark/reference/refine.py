"""Plain-torch reference of the photometric flow refinement: damped
Lucas-Kanade Gauss-Newton steps with Gaussian window aggregation, one pass per
(iters, sigma, radius) phase, each anchored at the net's flow, inside a trust
region of `max_total` px. A frozen copy of the port's `flow/refine.py` and of
the four-corner bilinear sample it uses (`ops/sampling.py`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _bilinear(img, xy):
    """img [B, H, W, C] at pixel coords xy [B, N, 2] -> [B, N, C], zero padding."""
    B, H, W, C = img.shape
    flat = img.reshape(-1, C)
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    base = (torch.arange(B, device=img.device) * (H * W)).view(B, 1)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        return flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)] * valid[..., None].to(img.dtype)

    return (((1 - dx) * (1 - dy))[..., None] * gather(y0i, x0i)
            + (dx * (1 - dy))[..., None] * gather(y0i, x0i + 1)
            + ((1 - dx) * dy)[..., None] * gather(y0i + 1, x0i)
            + (dx * dy)[..., None] * gather(y0i + 1, x0i + 1))


def _window(x, k1d):
    K, r = x.shape[1], (k1d.shape[0] - 1) // 2
    y = F.conv2d(x, k1d.view(1, 1, -1, 1).expand(K, 1, -1, 1), padding=(r, 0), groups=K)
    return F.conv2d(y, k1d.view(1, 1, 1, -1).expand(K, 1, 1, -1), padding=(0, r), groups=K)


def refine(img1s, img2s, flows, iters, anchors, sigma, radius, max_total,
           damp=1e-4, step_clamp=1.0, robust_thresh=0.25, min_weight=0.05):
    """One Gauss-Newton phase; images [B, H, W, 3] in [0, 1], flows [B, H, W, 2]."""
    dtype = flows.dtype

    def gray(img):
        return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).to(dtype)

    I1, I2 = gray(img1s), gray(img2s)
    B, H, W = I1.shape
    gx2, gy2 = torch.zeros_like(I2), torch.zeros_like(I2)
    gx2[..., :, 1:-1] = 0.5 * (I2[..., :, 2:] - I2[..., :, :-2])
    gy2[..., 1:-1, :] = 0.5 * (I2[..., 2:, :] - I2[..., :-2, :])
    I2s = torch.stack([I2, gx2, gy2], dim=-1)
    xk = torch.arange(-radius, radius + 1, dtype=dtype, device=flows.device)
    k1d = torch.exp(-0.5 * (xk / sigma) ** 2)
    k1d = k1d / k1d.sum()
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dtype, device=flows.device),
                            torch.arange(W, dtype=dtype, device=flows.device), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1)
    u = flows
    for _ in range(iters):
        pos = grid + u
        wrp = _bilinear(I2s, pos.reshape(B, -1, 2)).reshape(B, H, W, 3)
        I2w, gxw, gyw = wrp[..., 0], wrp[..., 1], wrp[..., 2]
        r = I2w - I1
        inb = ((pos[..., 0] >= 1.0) & (pos[..., 0] <= W - 2.0)
               & (pos[..., 1] >= 1.0) & (pos[..., 1] <= H - 2.0))
        wf = ((r.abs() < robust_thresh) & inb).to(dtype)
        fields = torch.stack([wf * gxw * gxw, wf * gxw * gyw, wf * gyw * gyw,
                              wf * gxw * r, wf * gyw * r, wf], dim=1)
        fA11, fA12, fA22, fb1, fb2, wsum = _window(fields, k1d).unbind(1)
        A11, A12, A22, b1, b2 = fA11 + damp, fA12, fA22 + damp, -fb1, -fb2
        det = A11 * A22 - A12 * A12
        du = torch.stack([(A22 * b1 - A12 * b2), (A11 * b2 - A12 * b1)], dim=-1) \
            / torch.clamp(det, min=1e-12)[..., None]
        du = torch.clamp(du, -step_clamp, step_clamp)
        ok = (wsum > min_weight) & (det > 1e-9) & inb
        u_new = u + torch.where(ok[..., None], du, torch.zeros_like(du))
        d = u_new - anchors
        n = torch.sqrt((d * d).sum(-1, keepdim=True))
        u = anchors + d * torch.clamp(max_total / torch.clamp(n, min=1e-9), max=1.0)
    return u


def refine_scheduled(img1s, img2s, flows, schedule, max_total):
    u = flows
    for iters, sigma, radius in schedule:
        u = refine(img1s, img2s, u, int(iters), flows, float(sigma), int(radius), max_total)
    return u
