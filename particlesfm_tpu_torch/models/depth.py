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


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
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
