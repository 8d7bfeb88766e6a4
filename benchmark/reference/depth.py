"""Plain-torch reference of the depth the pipeline hands to motion
segmentation: DepthNet (eval mode) on uint8 frames, normalised per frame to
[0, 1], rounded to float16 and back. A frozen copy of the port's
`models/depth.py` inference path.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def resize_bilinear(x, size):
    """Half-pixel bilinear resize of NCHW `x`, antialiased where it shrinks."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-2:]) == size:
        return x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=shrinks)


class ConvBlock(nn.Module):
    def __init__(self, in_ch, features, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.skip = None
        if stride != 1 or in_ch != features:
            self.skip = nn.Conv2d(in_ch, features, 1, stride=stride)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu((self.skip(x) if self.skip is not None else x) + y)


class FusionBlock(nn.Module):
    def __init__(self, deep_ch, skip_ch, features):
        super().__init__()
        self.fuse = ConvBlock(deep_ch + skip_ch, features)

    def forward(self, deep, skip):
        return self.fuse(torch.cat([resize_bilinear(deep, skip.shape[-2:]), skip], dim=1))


class DepthNet(nn.Module):
    """[N, 3, H, W] in [0, 255] -> relative inverse depth [N, H, W]."""

    def __init__(self, base=32):
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
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        d = self.dec1(self.dec2(self.dec3(self.dec4(e5, e4), e3), e2), e1)
        return F.relu(resize_bilinear(self.head(d), image.shape[-2:])[:, 0])


def frame_depths(model: DepthNet, frames):
    """uint8 frames [N, H, W, 3] -> the pipeline's depth [N, H, W]: min-max
    normalised per frame, through float16."""
    d = model(frames.to(torch.float32).permute(0, 3, 1, 2).contiguous())
    lo = d.amin(dim=(-2, -1), keepdim=True)
    hi = d.amax(dim=(-2, -1), keepdim=True)
    return ((d - lo) / torch.clamp(hi - lo, min=1e-12)).to(torch.float16).to(torch.float32)
