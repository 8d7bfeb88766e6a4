"""Plain-torch reference of the trajectory motion-segmentation net (eval
mode): 10-d trajectory features with depth back-projection, a transformer
over time, the OANet head, one logit per track. A frozen copy of the port's
`models/motionseg.py` inference path; DiffPool's softmax and pooling run in
float64 as there.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .depth import resize_bilinear


def _inorm(x, eps=1e-3):
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(x.var(dim=1, unbiased=False, keepdim=True) + eps)


class _BatchNorm(nn.Module):
    """flax BatchNorm over the last axis, eval mode."""

    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
                * self.weight + self.bias)


class _Attention(nn.Module):
    def __init__(self, d_model=16, nhead=4):
        super().__init__()
        self.nhead = nhead
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, kv, valid):
        S, Lq, D = x.shape
        h, d = self.nhead, D // self.nhead

        def heads(t):
            return t.reshape(S, -1, h, d).transpose(1, 2)

        logits = (heads(self.query(x)) / (d ** 0.5)) @ heads(self.key(kv)).transpose(-1, -2)
        logits = logits.masked_fill(~valid[:, None, None, :], torch.finfo(logits.dtype).min)
        y = torch.softmax(logits, dim=-1) @ heads(self.value(kv))
        return self.out(y.transpose(1, 2).reshape(S, Lq, D))


class _TransformerLayer(nn.Module):
    def __init__(self, d_model=16, nhead=4, dim_ff=64, cross=False):
        super().__init__()
        self.self_attn = _Attention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        if cross:
            self.cross_attn = _Attention(d_model, nhead)
            self.norm_cross = nn.LayerNorm(d_model, eps=1e-6)
        self.cross = cross
        self.ff1 = nn.Linear(d_model, dim_ff)
        self.ff2 = nn.Linear(dim_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x, valid, memory=None):
        x = self.norm1(x + self.self_attn(x, x, valid))
        if self.cross:
            x = self.norm_cross(x + self.cross_attn(x, memory, valid))
        return self.norm2(x + self.ff2(F.relu(self.ff1(x))))


class TrajTransformer(nn.Module):
    def __init__(self, d_model=16):
        super().__init__()
        self.d_model = d_model
        self.input_fc1 = nn.Linear(10, 16)
        self.fc2 = nn.Linear(16, d_model)
        self.enc0 = _TransformerLayer(d_model)
        self.enc1 = _TransformerLayer(d_model)
        self.dec0 = _TransformerLayer(d_model, cross=True)
        self.dec1 = _TransformerLayer(d_model, cross=True)

    def forward(self, feats, valid):
        B, N, L, _ = feats.shape
        x = F.relu(self.fc2(F.relu(self.input_fc1(feats)))).reshape(B * N, L, self.d_model)
        pad = valid.reshape(B * N, L)
        src = self.enc1(self.enc0(x, pad), pad)
        tgt = self.dec1(self.dec0(x, pad, src), pad, src).reshape(B, N, L, self.d_model)
        pooled = torch.where(valid[..., None], tgt, torch.full_like(tgt, -1e9)).amax(dim=2)
        return torch.where(valid.any(dim=2)[..., None], pooled, torch.zeros_like(pooled))


class PointCN(nn.Module):
    def __init__(self, channels, out_channels=None):
        super().__init__()
        out_ch = out_channels or channels
        self.bn1 = _BatchNorm(channels)
        self.conv1 = nn.Linear(channels, out_ch)
        self.bn2 = _BatchNorm(out_ch)
        self.conv2 = nn.Linear(out_ch, out_ch)
        self.shortcut = nn.Linear(channels, out_ch) if out_ch != channels else None

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(_inorm(x))))
        y = self.conv2(F.relu(self.bn2(_inorm(y))))
        return (self.shortcut(x) if self.shortcut is not None else x) + y


class DiffPool(nn.Module):
    def __init__(self, channels, clusters):
        super().__init__()
        self.bn = _BatchNorm(channels)
        self.embed = nn.Linear(channels, clusters)

    def forward(self, x):
        e = self.embed(F.relu(self.bn(_inorm(x))))
        w = torch.softmax(e.double(), dim=1).transpose(1, 2)
        return (w @ x.double()).to(x.dtype)


class DiffUnpool(nn.Module):
    def __init__(self, channels, clusters):
        super().__init__()
        self.bn = _BatchNorm(channels)
        self.embed = nn.Linear(channels, clusters)

    def forward(self, x_up, x_down):
        return torch.softmax(self.embed(F.relu(self.bn(_inorm(x_up)))), dim=2) @ x_down


class OAFilter(nn.Module):
    def __init__(self, channels, points):
        super().__init__()
        self.bn1 = _BatchNorm(channels)
        self.conv1 = nn.Linear(channels, channels)
        self.bn2 = _BatchNorm(points)
        self.conv2 = nn.Linear(points, points)
        self.bn3 = _BatchNorm(channels)
        self.conv3 = nn.Linear(channels, channels)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(_inorm(x))))
        y = y + self.conv2(F.relu(self.bn2(y.transpose(1, 2)))).transpose(1, 2)
        return x + self.conv3(F.relu(self.bn3(_inorm(y))))


class OANBlock(nn.Module):
    def __init__(self, in_channels=16, c=128, depth=8, clusters=100):
        super().__init__()
        self.depth = depth
        self.conv1 = nn.Linear(in_channels, c)
        for i in range(depth // 2):
            setattr(self, f"l1_1_{i}", PointCN(c))
            setattr(self, f"l2_{i}", OAFilter(c, clusters))
            setattr(self, f"l1_2_{i}", PointCN(2 * c, c) if i == 0 else PointCN(c))
        self.down1 = DiffPool(c, clusters)
        self.up1 = DiffUnpool(c, clusters)
        self.output = nn.Linear(c, 1)

    def forward(self, x):
        n = self.depth // 2
        x1 = self.conv1(x)
        for i in range(n):
            x1 = getattr(self, f"l1_1_{i}")(x1)
        xd = self.down1(x1)
        for i in range(n):
            xd = getattr(self, f"l2_{i}")(xd)
        out = torch.cat([x1, self.up1(x1, xd)], dim=-1)
        for i in range(n):
            out = getattr(self, f"l1_2_{i}")(out)
        return self.output(out)[..., 0]


def _features(traj, depth_maps, valid, hw):
    h, w = hw
    f = (h + w) / 2.0
    x_pix = torch.clamp((traj[..., 0] * w).to(torch.int32), 0, w - 1).long()
    y_pix = torch.clamp((traj[..., 1] * h).to(torch.int32), 0, h - 1).long()
    B, N, L = x_pix.shape
    d = depth_maps[torch.arange(B, device=traj.device)[:, None, None],
                   torch.arange(L, device=traj.device)[None, None, :], y_pix, x_pix]
    t3 = torch.stack([d * (x_pix.to(d.dtype) - w / 2.0) / f,
                      d * (y_pix.to(d.dtype) - h / 2.0) / f, d], dim=-1)
    nxt = valid[..., 1:, None].to(traj.dtype)

    def motion(t):
        return torch.cat([(t[..., 1:, :] - t[..., :-1, :]) * nxt, torch.zeros_like(t[..., :1, :])],
                         dim=-2)

    return torch.cat([traj, motion(traj), t3, motion(t3)], dim=-1)


class TrajOADepth(nn.Module):
    def __init__(self, input_hw):
        super().__init__()
        self.input_hw = tuple(input_hw)
        self.joint_encoder = TrajTransformer()
        self.decoder = OANBlock()

    def forward(self, traj, depth_maps, valid):
        return self.decoder(self.joint_encoder(_features(traj, depth_maps, valid, self.input_hw),
                                               valid))


def window_logits(model: TrajOADepth, traj_u16, depth, valid):
    """The pipeline's seg call: trajectories as u16 fixed point [B, K, L, 2],
    full-resolution depth [B, L, H, W], validity [B, K, L] -> logits [B, K]."""
    t = traj_u16.to(torch.float32) * (1.0 / 65535.0)
    return model(t, resize_bilinear(depth.to(torch.float32), model.input_hw), valid)
