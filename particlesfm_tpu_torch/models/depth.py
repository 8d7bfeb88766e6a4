"""Monocular relative-depth network (port of particlesfm_tpu/models/depth.py:19-77).

Image -> relative inverse depth, normalized to [0, 1] per frame: the contract
of the reference's 16-bit depth PNGs, consumed only by the motion-seg
featurization. NCHW inside; module names follow the flax parameter tree, so
`io.checkpoint.depth_state_dict_from_jax` carries the checkpoint over by path.
Every 3x3 conv has the flax model's padding 1; the 1x1 stride-2 `skip` (flax
SAME) pads nothing.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel bilinear resize of the last two axes of NCHW `x` to `size`,
    as jax.image.resize(..., "bilinear") does: antialiased where the image
    shrinks (the JAX call scales its triangle kernel there), plain otherwise."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-2:]) == size:
        return x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrinks)


class PerImageBatchNorm2d(nn.BatchNorm2d):
    """flax nn.BatchNorm (momentum 0.99, eps 1e-5) as the reference trains it,
    vmapped over images (depth/train.py:109-122).

    Train mode: each image is normalized with its own statistics over H x W
    (the variance as E[x^2] - E[x]^2, flax's fast variance), and the running
    statistics move by 0.01 of the batch mean of the images' statistics,
    the variance biased (nn.BatchNorm2d's train mode normalizes over the
    whole batch, keeps 0.9 and an unbiased variance). Eval mode is
    nn.BatchNorm2d's."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__(features, eps=eps)
        self.flax_momentum = momentum

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(-2, -1), keepdim=True)                       # [N, C, 1, 1]
        var = torch.clamp((x * x).mean(dim=(-2, -1), keepdim=True) - mean * mean, min=0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_((1 - m) * mean.mean(0).flatten())
            self.running_var.mul_(m).add_((1 - m) * var.mean(0).flatten())
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1)
        self.bn1 = PerImageBatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = PerImageBatchNorm2d(features)
        self.skip = None
        if stride != 1 or in_ch != features:
            self.skip = nn.Conv2d(in_ch, features, 1, stride=stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.skip is not None:
            x = self.skip(x)
        return F.relu(x + y)


class FusionBlock(nn.Module):
    """MiDaS-style refinement: upsample deep features, fuse with the skip."""

    def __init__(self, deep_ch: int, skip_ch: int, features: int):
        super().__init__()
        self.fuse = ConvBlock(deep_ch + skip_ch, features)

    def forward(self, deep, skip):
        up = resize_bilinear(deep, skip.shape[-2:])
        return self.fuse(torch.cat([up, skip], dim=1))


class DepthNet(nn.Module):
    """Relative inverse-depth estimator: [N, 3, H, W] in [0, 255] -> [N, H, W]."""

    def __init__(self, base: int = 32):
        super().__init__()
        b = base
        chans = (3, b, 2 * b, 4 * b, 8 * b, 8 * b)
        for i in range(5):
            setattr(self, f"enc{i + 1}", ConvBlock(chans[i], chans[i + 1], 2))
        self.dec4 = FusionBlock(8 * b, 8 * b, 8 * b)
        self.dec3 = FusionBlock(8 * b, 4 * b, 4 * b)
        self.dec2 = FusionBlock(4 * b, 2 * b, 2 * b)
        self.dec1 = FusionBlock(2 * b, b, b)
        self.head = nn.Conv2d(b, 1, 3, padding=1)

    def forward(self, image):
        x = (image / 255.0 - 0.5) * 2.0
        e1 = self.enc1(x)           # /2
        e2 = self.enc2(e1)          # /4
        e3 = self.enc3(e2)          # /8
        e4 = self.enc4(e3)          # /16
        e5 = self.enc5(e4)          # /32
        d = self.dec4(e5, e4)
        d = self.dec3(d, e3)
        d = self.dec2(d, e2)
        d = self.dec1(d, e1)
        out = resize_bilinear(self.head(d), image.shape[-2:])
        return F.relu(out[:, 0])    # nonnegative relative inverse depth


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    """Per-frame min-max normalization of [N, H, W] to [0, 1] (the on-disk
    contract of the reference's 16-bit depth PNGs)."""
    lo = depth.amin(dim=(-2, -1), keepdim=True)
    hi = depth.amax(dim=(-2, -1), keepdim=True)
    return (depth - lo) / torch.clamp(hi - lo, min=1e-12)


def scale_shift_invariant_loss(pred, target, mask):
    """SSI MSE of one image or a batch of them (the last two axes are H, W):
    pred aligned to target by the least-squares scale and shift over the
    masked pixels, then the masked MSE (models/depth.py:80-91)."""
    m = mask.to(pred.dtype)
    dims = (-2, -1)
    n = torch.clamp(m.sum(dims), min=1.0)
    px = (pred * m).sum(dims) / n
    tx = (target * m).sum(dims) / n
    pc = pred - px[..., None, None]
    cov = (pc * (target - tx[..., None, None]) * m).sum(dims) / n
    var = (pc ** 2 * m).sum(dims) / n
    s = cov / torch.clamp(var, min=1e-12)
    b = tx - s * px
    return (((s[..., None, None] * pred + b[..., None, None]) - target) ** 2 * m).sum(dims) / n
