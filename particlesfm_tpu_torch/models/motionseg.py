"""Trajectory motion-segmentation network: transformer encoder + OANet decoder
(port of particlesfm_tpu/models/motionseg.py:29-225).

Channel-last [B, N, C] with `nn.Linear` for every 1x1 conv; module names
follow the flax parameter tree, so `io.checkpoint.motionseg_state_dict_from_jax`
carries the checkpoint over by path. The flax model's numerics are kept where
they decide labels:
- LayerNorm eps is flax's 1e-6, BatchNorm eps 1e-5;
- every BatchNorm is an affine on the last axis, including OAFilter.bn2,
  which normalizes the cluster axis after a swap;
- masked attention logits take finfo(f32).min, not -inf, so a fully masked
  row (a padded track slot) gets uniform weights and stays finite;
- instance norm (eps 1e-3, population variance) and DiffPool's softmax run
  over the track axis, padded slots included.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _instance_norm_points(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """InstanceNorm for [B, N, C]: normalize over N per (B, C)."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class _BatchNorm(nn.Module):
    """flax nn.BatchNorm over the last axis (momentum 0.99, eps 1e-5).

    Eval mode: an affine from the running averages. Train mode: statistics
    over every axis but the last, padded tracks included, the variance as
    E[x^2] - E[x]^2 (flax's fast variance); the running averages keep 0.99
    and take 0.01 of the batch's mean and biased variance."""

    def __init__(self, n: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        if not self.training:
            return ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
                    * self.weight + self.bias)
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class _Attention(nn.Module):
    """flax MultiHeadDotProductAttention with a key-padding mask."""

    def __init__(self, d_model: int = 16, nhead: int = 4):
        super().__init__()
        self.nhead = nhead
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, kv, valid):
        # x [S, Lq, D], kv [S, Lk, D], valid [S, Lk] True where the key is valid
        S, Lq, D = x.shape
        h, d = self.nhead, D // self.nhead

        def heads(t):
            return t.reshape(S, -1, h, d).transpose(1, 2)           # [S, h, L, d]

        q = heads(self.query(x)) / (d ** 0.5)
        k = heads(self.key(kv))
        v = heads(self.value(kv))
        logits = q @ k.transpose(-1, -2)                              # [S, h, Lq, Lk]
        logits = logits.masked_fill(~valid[:, None, None, :], torch.finfo(logits.dtype).min)
        y = torch.softmax(logits, dim=-1) @ v                         # [S, h, Lq, d]
        return self.out(y.transpose(1, 2).reshape(S, Lq, D))


class _TransformerLayer(nn.Module):
    """Post-norm transformer layer (torch nn.TransformerEncoder/DecoderLayer)."""

    def __init__(self, d_model: int = 16, nhead: int = 4, dim_ff: int = 64,
                 cross: bool = False):
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
    """Project the 10-d features, run the enc-dec over time, max-pool."""

    def __init__(self, d_model: int = 16):
        super().__init__()
        self.d_model = d_model
        self.input_fc1 = nn.Linear(10, 16)
        self.fc2 = nn.Linear(16, d_model)
        self.enc0 = _TransformerLayer(d_model)
        self.enc1 = _TransformerLayer(d_model)
        self.dec0 = _TransformerLayer(d_model, cross=True)
        self.dec1 = _TransformerLayer(d_model, cross=True)

    def forward(self, feats, valid):
        # feats [B, N, L, 10], valid [B, N, L] bool
        B, N, L, _ = feats.shape
        x = F.relu(self.fc2(F.relu(self.input_fc1(feats)))).reshape(B * N, L, self.d_model)
        pad = valid.reshape(B * N, L)
        src = self.enc1(self.enc0(x, pad), pad)
        tgt = self.dec1(self.dec0(x, pad, src), pad, src).reshape(B, N, L, self.d_model)
        # masked max over time; fully invalid (padded) tracks pool to 0
        pooled = torch.where(valid[..., None], tgt, torch.full_like(tgt, -1e9)).amax(dim=2)
        return torch.where(valid.any(dim=2)[..., None], pooled, torch.zeros_like(pooled))


class PointCN(nn.Module):
    def __init__(self, channels: int, out_channels: int | None = None):
        super().__init__()
        out_ch = out_channels or channels
        self.bn1 = _BatchNorm(channels)
        self.conv1 = nn.Linear(channels, out_ch)
        self.bn2 = _BatchNorm(out_ch)
        self.conv2 = nn.Linear(out_ch, out_ch)
        self.shortcut = nn.Linear(channels, out_ch) if out_ch != channels else None

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(_instance_norm_points(x))))
        y = self.conv2(F.relu(self.bn2(_instance_norm_points(y))))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + y


class DiffPool(nn.Module):
    def __init__(self, channels: int, clusters: int):
        super().__init__()
        self.bn = _BatchNorm(channels)
        self.embed = nn.Linear(channels, clusters)

    def forward(self, x):
        # x [B, N, C] -> [B, K, C] via soft assignment over the points. The
        # softmax over N and the pooling run in float64 (the reference: float32
        # under XLA): over a chunk of 13,107 tracks the assignments are near
        # uniform, the pooled clusters nearly equal, and the instance norms
        # over the clusters downstream amplify the rounding of torch's float32
        # softmax over a non-last axis to ~3e-3 in the logits, enough to
        # move them when the tracks are merely reordered.
        e = self.embed(F.relu(self.bn(_instance_norm_points(x))))    # [B, N, K]
        w = torch.softmax(e.double(), dim=1).transpose(1, 2)
        return (w @ x.double()).to(x.dtype)


class DiffUnpool(nn.Module):
    def __init__(self, channels: int, clusters: int):
        super().__init__()
        self.bn = _BatchNorm(channels)
        self.embed = nn.Linear(channels, clusters)

    def forward(self, x_up, x_down):
        # x_up [B, N, C] (pre-pool features), x_down [B, K, C]
        e = self.embed(F.relu(self.bn(_instance_norm_points(x_up))))  # [B, N, K]
        return torch.softmax(e, dim=2) @ x_down


class OAFilter(nn.Module):
    def __init__(self, channels: int, points: int):
        super().__init__()
        self.bn1 = _BatchNorm(channels)
        self.conv1 = nn.Linear(channels, channels)
        self.bn2 = _BatchNorm(points)            # the cluster axis, after the swap
        self.conv2 = nn.Linear(points, points)
        self.bn3 = _BatchNorm(channels)
        self.conv3 = nn.Linear(channels, channels)

    def forward(self, x):
        # x [B, K, C]; the spatial correlation layer mixes the cluster axis
        y = self.conv1(F.relu(self.bn1(_instance_norm_points(x))))
        z = self.conv2(F.relu(self.bn2(y.transpose(1, 2))))         # [B, C, K]
        y = y + z.transpose(1, 2)
        return x + self.conv3(F.relu(self.bn3(_instance_norm_points(y))))


class OANBlock(nn.Module):
    def __init__(self, in_channels: int = 16, net_channels: int = 128, depth: int = 8,
                 clusters: int = 100):
        super().__init__()
        c = net_channels
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
        # x [B, N, C_in] -> logits [B, N]
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


def backproject_tracks(depth_maps, traj, hw: Tuple[int, int]):
    """Per-point 3-d backprojection with the assumed intrinsics f = (h + w) / 2,
    c = (w / 2, h / 2). depth_maps [B, L, H, W]; traj [B, N, L, 2] normalized
    to [0, 1] (pixel indices truncate toward zero). Returns [B, N, L, 3]."""
    h, w = hw
    f = (h + w) / 2.0
    x_pix = torch.clamp((traj[..., 0] * w).to(torch.int32), 0, w - 1).long()
    y_pix = torch.clamp((traj[..., 1] * h).to(torch.int32), 0, h - 1).long()
    B, N, L = x_pix.shape
    b_idx = torch.arange(B, device=traj.device)[:, None, None]
    l_idx = torch.arange(L, device=traj.device)[None, None, :]
    d = depth_maps[b_idx, l_idx, y_pix, x_pix]                      # [B, N, L]
    X = d * (x_pix.to(d.dtype) - w / 2.0) / f
    Y = d * (y_pix.to(d.dtype) - h / 2.0) / f
    return torch.stack([X, Y, d], dim=-1)


def augment_traj(traj, depth_maps, valid, hw):
    """10-d per-point features: xy, 2-d motion, backprojected 3-d point and
    3-d motion; the temporal differences are zero where the next observation
    is invalid."""
    traj3d = backproject_tracks(depth_maps, traj, hw)
    nxt_ok = valid[..., 1:, None].to(traj.dtype)

    def motion(t):
        return torch.cat([(t[..., 1:, :] - t[..., :-1, :]) * nxt_ok,
                          torch.zeros_like(t[..., :1, :])], dim=-2)

    return torch.cat([traj, motion(traj), traj3d, motion(traj3d)], dim=-1)


class TrajOADepth(nn.Module):
    """augment -> trajectory transformer -> OANet head -> logits."""

    def __init__(self, input_hw: Tuple[int, int] = (240, 424)):
        super().__init__()
        self.input_hw = tuple(input_hw)
        self.joint_encoder = TrajTransformer()
        self.decoder = OANBlock()

    def forward(self, traj, depth_maps, valid):
        """traj [B, N, L, 2] normalized coords; depth_maps [B, L, h, w] in [0, 1]
        at `input_hw`; valid [B, N, L] bool. Returns motion logits [B, N]
        (sigmoid -> dynamic)."""
        feats = augment_traj(traj, depth_maps, valid, self.input_hw)
        return self.decoder(self.joint_encoder(feats, valid))
