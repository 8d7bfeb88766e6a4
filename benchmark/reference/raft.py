"""Plain-torch reference of the flow the pipeline computes for an image pair:
the RAFT net with a plain correlation lookup, edge padding to a multiple of 8,
then the photometric refinement (`reference/refine.py`).

A frozen copy of the port's `models/raft.py` (inference only) with the plain
four-corner lookup in place of kernel K1. Module names follow the flax
parameter tree, so `checkpoint.conv_state_dict` loads the repo's checkpoints.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .refine import refine_scheduled


def lookup_plain(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """pyramid: [B, P, Hl, Wl] per level; coords [B, P, 2] (x, y) at level-0
    scale -> [B, P, L*(2r+1)^2], ordered level, dy, dx; zero off the map."""
    B, P = coords.shape[:2]
    r = radius
    d = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], dim=-1).reshape(-1, 2)
    rows = torch.arange(B * P, device=coords.device).view(B, P, 1)
    out = []
    for lvl, corr in enumerate(pyramid):
        Hl, Wl = corr.shape[-2:]
        flat = corr.reshape(B * P, Hl * Wl)
        pts = coords.view(B, P, 1, 2) / (2.0 ** lvl) + delta
        x, y = pts[..., 0], pts[..., 1]
        x0, y0 = torch.floor(x), torch.floor(y)
        wx, wy = x - x0, y - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

        def gather(yi, xi):
            valid = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
            v = flat[rows, yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)]
            return v * valid.to(corr.dtype)

        out.append((1 - wx) * (1 - wy) * gather(y0i, x0i) + wx * (1 - wy) * gather(y0i, x0i + 1)
                   + (1 - wx) * wy * gather(y0i + 1, x0i) + wx * wy * gather(y0i + 1, x0i + 1))
    return torch.cat(out, dim=-1)


def _instance_norm(x):
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class _InstanceNorm(nn.Module):
    def forward(self, x):
        return _instance_norm(x)


def _norm(kind: str, planes: int) -> nn.Module:
    return nn.BatchNorm2d(planes, eps=1e-5) if kind == "batch" else _InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, stride=1, norm="instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.norm1 = _norm(norm, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Conv2d(in_planes, planes, 1, stride=stride)
            self.norm3 = _norm(norm, planes)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm, base):
        super().__init__()
        b = base
        self.conv1 = nn.Conv2d(3, b, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, b)
        in_planes = b
        for i, (planes, stride) in enumerate(((b, 1), (3 * b // 2, 2), (2 * b, 2))):
            setattr(self, f"layer{i + 1}_0", ResidualBlock(in_planes, planes, stride, norm))
            setattr(self, f"layer{i + 1}_1", ResidualBlock(planes, planes, 1, norm))
            in_planes = planes
        self.conv2 = nn.Conv2d(in_planes, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        for i in range(3):
            x = getattr(self, f"layer{i + 1}_1")(getattr(self, f"layer{i + 1}_0")(x))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels, d):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, d[0], 1)
        self.convc2 = nn.Conv2d(d[0], d[1], 3, padding=1)
        self.convf1 = nn.Conv2d(2, d[2], 7, padding=3)
        self.convf2 = nn.Conv2d(d[2], d[3], 3, padding=1)
        self.conv = nn.Conv2d(d[1] + d[3], d[4] - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], dim=1))), flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden, input_dim):
        super().__init__()
        c = hidden + input_dim
        for tag, ksize, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{tag}", nn.Conv2d(c, hidden, ksize, padding=pad))

    def forward(self, h, x):
        for tag in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim, hidden):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    def __init__(self, corr_channels, hidden_dim, context_dim, motion_dims, head_hidden,
                 mask_hidden):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, motion_dims)
        self.gru = SepConvGRU(hidden_dim, context_dim + motion_dims[4])
        self.flow_head = FlowHead(hidden_dim, head_hidden)
        self.mask_conv1 = nn.Conv2d(hidden_dim, mask_hidden, 3, padding=1)
        self.mask_conv2 = nn.Conv2d(mask_hidden, 576, 1)


def upsample_convex(flow, mask):
    """flow [B, 2, H, W], mask [B, 576, H, W] (channel a*72 + b*9 + n)."""
    B, _, H, W = flow.shape
    mask = torch.softmax(mask.view(B, 1, 8, 8, 9, H, W), dim=4)
    neigh = F.unfold(8.0 * flow, 3, padding=1).view(B, 2, 1, 1, 9, H, W)
    up = (mask * neigh).sum(dim=4)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """Image pairs [B, H, W, 3] in [0, 255] (H, W multiples of 8) -> flow
    [B, H, W, 2]. `width` names the configuration: "compact" is the repo's
    checkpoint, "things" the published raft-things widths."""

    WIDTHS = {
        "compact": dict(hidden_dim=64, context_dim=64, enc_dim=128, enc_base=32,
                        motion_dims=(96, 64, 48, 32, 64), head_hidden=128, mask_hidden=128,
                        cnet_norm="instance"),
        "things": dict(hidden_dim=128, context_dim=128, enc_dim=256, enc_base=64,
                       motion_dims=(256, 192, 128, 64, 128), head_hidden=256, mask_hidden=256,
                       cnet_norm="batch"),
    }

    def __init__(self, width="compact", num_levels=4, radius=4):
        super().__init__()
        w = self.WIDTHS[width]
        self.num_levels, self.radius, self.hidden_dim = num_levels, radius, w["hidden_dim"]
        self.fnet = BasicEncoder(w["enc_dim"], "instance", w["enc_base"])
        self.cnet = BasicEncoder(w["hidden_dim"] + w["context_dim"], w["cnet_norm"],
                                 w["enc_base"])
        self.update_block = UpdateBlock(num_levels * (2 * radius + 1) ** 2, w["hidden_dim"],
                                        w["context_dim"], w["motion_dims"], w["head_hidden"],
                                        w["mask_hidden"])

    def forward(self, image1, image2, iters):
        B = image1.shape[0]
        imgs = 2.0 * (torch.cat([image1, image2], dim=0).permute(0, 3, 1, 2) / 255.0) - 1.0
        fmaps = self.fnet(imgs)
        cnet = self.cnet(imgs[:B])
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = F.relu(cnet[:, self.hidden_dim:])
        f1, f2 = fmaps[:B], fmaps[B:]
        D, H8, W8 = f1.shape[1:]
        corr = torch.bmm(f1.reshape(B, D, -1).transpose(1, 2), f2.reshape(B, D, -1))
        corr = (corr / torch.sqrt(torch.tensor(float(D), dtype=f1.dtype))).view(
            B * H8 * W8, 1, H8, W8)
        pyramid = [corr.view(B, H8 * W8, H8, W8)]
        for _ in range(self.num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            pyramid.append(corr.view(B, H8 * W8, corr.shape[-2], corr.shape[-1]))
        ys, xs = torch.meshgrid(torch.arange(H8, dtype=net.dtype, device=net.device),
                                torch.arange(W8, dtype=net.dtype, device=net.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], dim=0).expand(B, 2, H8, W8)
        coords1 = coords0
        ub = self.update_block
        for _ in range(iters):
            pts = coords1.permute(0, 2, 3, 1).reshape(B, H8 * W8, 2).contiguous()
            cf = lookup_plain(pyramid, pts, self.radius).view(B, H8, W8, -1).permute(0, 3, 1, 2)
            motion = ub.encoder(coords1 - coords0, cf)
            net = ub.gru(net, torch.cat([inp, motion], dim=1))
            coords1 = coords1 + ub.flow_head(net)
        mask = 0.25 * ub.mask_conv2(F.relu(ub.mask_conv1(net)))
        return upsample_convex(coords1 - coords0, mask).permute(0, 2, 3, 1)


def pair_flows(model: RAFT, frames1, frames2, iters: int, schedule, max_total: float):
    """Flows [B, H, W, 2] of frame pairs given as [B, H, W, 3] (uint8 or float in
    [0, 255]): edge-pad to multiples of 8, the net, crop, then refinement with
    `schedule` ((iters, sigma, radius) phases) anchored at the net's flow."""
    raw1, raw2 = frames1.to(torch.float32), frames2.to(torch.float32)
    H, W = raw1.shape[1:3]
    ph, pw = (-H) % 8, (-W) % 8

    def pad(x):
        return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)

    i1, i2 = (pad(raw1), pad(raw2)) if ph or pw else (raw1, raw2)
    fl = model(i1, i2, iters)[:, :H, :W]
    if schedule:
        fl = refine_scheduled(raw1 / 255.0, raw2 / 255.0, fl, schedule, max_total)
    return fl
