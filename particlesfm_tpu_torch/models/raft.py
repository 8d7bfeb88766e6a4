"""RAFT-class recurrent optical flow network (port of particlesfm_tpu/models/raft.py).

Module names match the flax parameter tree one for one, so
`io.checkpoint.raft_state_dict_from_jax` carries the repo's checkpoints over
by path. Tensors are NCHW inside; channel orders follow the JAX model:
- correlation features are level, then dy, then dx (raft.py:106-111,207);
- concatenations keep the flax order (raft.py:226,228,238,243,282);
- the upsampling mask is [8, 8, 9] per pixel, channel = a*72 + b*9 + n
  (raft.py:295), not torch RAFT's n*64 + a*8 + b.
Every conv larger than 1x1 has the flax model's explicit symmetric padding;
the 1x1 stride-2 `downsample` (flax SAME) pads nothing.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.corr_lookup import lookup_corr
from ..utils import profiling


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W: biased variance,
    eps 1e-5, no affine (raft.py:25)."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def _norm(kind: str, planes: int) -> nn.Module:
    if kind == "batch":
        return nn.BatchNorm2d(planes, eps=1e-5)
    if kind == "instance":
        return _InstanceNorm()
    return nn.Identity()


class _InstanceNorm(nn.Module):
    def forward(self, x):
        return _instance_norm(x)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, norm: str = "instance"):
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
    def __init__(self, output_dim: int = 256, norm: str = "instance", base: int = 64):
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
            x = getattr(self, f"layer{i + 1}_0")(x)
            x = getattr(self, f"layer{i + 1}_1")(x)
        return self.conv2(x)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4):
    """All-pairs correlation + 2x2-average-pooled pyramid.

    fmap1, fmap2: [B, D, H, W] (1/8 resolution). Returns a list of contiguous
    [B, H*W, Hl, Wl] per-pixel correlation maps."""
    B, D, H, W = fmap1.shape
    f1 = fmap1.reshape(B, D, H * W).transpose(1, 2)
    f2 = fmap2.reshape(B, D, H * W)
    corr = torch.bmm(f1, f2) / torch.sqrt(torch.tensor(float(D), dtype=fmap1.dtype))
    corr = corr.view(B * H * W, 1, H, W)
    pyramid = [corr.view(B, H * W, H, W)]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr.view(B, H * W, corr.shape[-2], corr.shape[-1]))
    return pyramid


def _abs(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's derivative at 0 (+1; torch's abs gives 0 there)."""
    return torch.where(d >= 0, d, -d)


def lookup_corr_hat(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The training lookup: a port of the reference's XLA formulation
    (raft.py:145-208 `lookup_corr`, selected by `use_pallas=False`, which the
    JAX trainer uses). Per level, each pixel's 2r+2 map rows around its
    target are gathered, then the bilinear weights of all (2r+1)^2 offsets
    are hat functions over the row's lanes (x) and over the gathered rows (y,
    zero for rows off the map), contracted in turn. Gradients reach both the
    correlation maps and the coordinates, as JAX's do, kinks included (at a
    hat's foot the gradient splits in half, as jnp.maximum's does; at its
    peak it is jnp.abs's +1), so integer coordinates match too.

    The contractions are products summed elementwise, not matmuls, so they
    stay full float32 whatever the TF32 policy (the reference forces
    Precision.HIGHEST there). pyramid: [B, P, Hl, Wl] per level; coords
    [B, P, 2] (x, y) at level-0 scale -> [B, P, L*(2r+1)^2]."""
    B, P = coords.shape[:2]
    r = radius
    nw = 2 * r + 2
    offs = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        Hl, Wl = corr.shape[-2:]
        c = coords / (2.0 ** lvl)
        cx, cy = c[..., 0], c[..., 1]                                   # [B, P]
        y0 = torch.floor(cy).to(torch.int64) - r
        ri = y0[..., None] + torch.arange(nw, device=coords.device)     # [B, P, nw]
        rows = corr.gather(2, ri.clamp(0, Hl - 1)[..., None].expand(B, P, nw, Wl))
        lanes = torch.arange(Wl, dtype=coords.dtype, device=coords.device)
        zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
        tx = cx[..., None] + offs                                       # [B, P, 9]
        Xw = torch.maximum(zero, 1.0 - _abs(lanes[:, None] - tx[..., None, :]))
        ty = cy[..., None] + offs
        yin = ((ri >= 0) & (ri < Hl)).to(coords.dtype)
        Yw = torch.maximum(zero, 1.0 - _abs(ri.to(coords.dtype)[..., None]
                                            - ty[..., None, :])) * yin[..., None]
        t1 = (rows[..., None] * Xw[..., None, :, :]).sum(-2)            # [B, P, nw, 9(dx)]
        val = (Yw[..., None] * t1[..., None, :]).sum(-3)                # [B, P, 9(dy), 9(dx)]
        out.append(val.reshape(B, P, (2 * r + 1) ** 2))
    return torch.cat(out, dim=-1)


class _Im2colConv2d(nn.Conv2d):
    """An `nn.Conv2d` that always runs PyTorch's own im2col + GEMM
    convolution (`aten.thnn_conv2d`, the path `F.conv2d` takes on a card
    without cuDNN), never cuDNN. `BasicMotionEncoder` builds its 3x3
    convolutions of 256 or more input channels as this class: the
    raft-things motion encoder's `convc2` and `conv`; the compact net has
    none.

    On an H100 with TF32 off (cuDNN 9.2, torch 2.11), cuDNN's heuristics run
    those two as FFTs that launch a small complex GEMM per tile: at
    8 x 55 x 128, 256 -> 126 channels took 334 ms a call against 1.4 ms
    here, and 256 -> 192 25.5 ms against 2.0. The 256-channel rule is set
    by rounding, not by speed: the compact net's 64 -> 128 heads are faster
    here too (0.46 against 4.7 ms a call), but moved off cuDNN their
    rounding changed the accepted cells' poses (scannet scene 0's focal
    error 0.0077 -> 0.0608), so the compact net keeps cuDNN."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.ops.aten.thnn_conv2d(x, self.weight, self.kernel_size, self.bias,
                                          self.stride, self.padding)


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """A 3x3 convolution, padding 1, off cuDNN from 256 input channels
    (`_Im2colConv2d`)."""
    return (_Im2colConv2d if cin >= 256 else nn.Conv2d)(cin, cout, 3, padding=1)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int, dims=(256, 192, 128, 64, 128)):
        super().__init__()
        d = dims
        self.convc1 = nn.Conv2d(corr_channels, d[0], 1)
        self.convc2 = _conv3x3(d[0], d[1])
        self.convf1 = nn.Conv2d(2, d[2], 7, padding=3)
        self.convf2 = nn.Conv2d(d[2], d[3], 3, padding=1)
        self.conv = _conv3x3(d[1] + d[3], d[4] - 2)

    def forward(self, flow, corr):
        c = F.relu(self.convc1(corr))
        c = F.relu(self.convc2(c))
        f = F.relu(self.convf1(flow))
        f = F.relu(self.convf2(f))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, input_dim: int):
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
    def __init__(self, input_dim: int, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    """One GRU update: motion encoder, SepConvGRU, flow head and the
    upsampling-mask head (raft.py:260-288, the flax scan body)."""

    def __init__(self, corr_channels, hidden_dim, context_dim, motion_dims,
                 head_hidden, mask_hidden):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, motion_dims)
        self.gru = SepConvGRU(hidden_dim, context_dim + motion_dims[4])
        self.flow_head = FlowHead(hidden_dim, head_hidden)
        self.mask_conv1 = nn.Conv2d(hidden_dim, mask_hidden, 3, padding=1)
        self.mask_conv2 = nn.Conv2d(mask_hidden, 576, 1)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)

    def mask(self, net):
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)))


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling: each output pixel is a softmax combination of its
    coarse pixel's 3x3 neighbours. flow [B, 2, H, W], mask [B, 576, H, W]
    (channel a*72 + b*9 + n) -> [B, 2, 8H, 8W]."""
    B, _, H, W = flow.shape
    mask = torch.softmax(mask.view(B, 1, 8, 8, 9, H, W), dim=4)
    neigh = F.unfold(8.0 * flow, 3, padding=1).view(B, 2, 1, 1, 9, H, W)
    up = (mask * neigh).sum(dim=4)                            # [B, 2, 8a, 8b, H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """RAFT on image pairs [B, H, W, 3] in [0, 255] -> flow [B, H, W, 2].

    Defaults are the raft-things configuration; `compact_raft()` builds the
    configuration of the repo's checkpoint. The GRU iterations are a Python
    loop over one shared update block. The `lookup` attribute is the
    correlation lookup, `ops.corr_lookup.lookup_corr` (kernel K1 on CUDA, plain
    on the CPU); the trainers select `lookup_corr_hat`, as the JAX trainer runs
    its XLA lookup; chip_smoke.py swaps in `lookup_corr_plain` to hold the
    net's flow with K1 against the plain version on the card. `remat`
    recomputes each GRU iteration in the backward pass
    (`torch.utils.checkpoint`, the flax model's nn.remat).
    """

    def __init__(self, num_levels=4, radius=4, hidden_dim=128, context_dim=128,
                 enc_dim=256, enc_base=64, motion_dims=(256, 192, 128, 64, 128),
                 head_hidden=256, mask_hidden=256, cnet_norm="batch", remat=False):
        super().__init__()
        self.num_levels = num_levels
        self.radius = radius
        self.hidden_dim = hidden_dim
        self.remat = remat
        self.lookup = lookup_corr
        self.fnet = BasicEncoder(enc_dim, "instance", enc_base)
        self.cnet = BasicEncoder(hidden_dim + context_dim, cnet_norm, enc_base)
        self.update_block = UpdateBlock(
            num_levels * (2 * radius + 1) ** 2, hidden_dim, context_dim,
            tuple(motion_dims), head_hidden, mask_hidden)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 20,
                all_iters: bool = False):
        """all_iters: every iteration's upsampled flow, with that iteration's
        mask, [B, iters, H, W, 2] (the sequence loss's input, raft.py:367).

        With tracing on (`utils.profiling`), the encoders and the correlation
        pyramid are span `flow.encode` and the GRU iterations with their
        lookups span `flow.update`, timed on the input's device; counter
        `flow.gru_iters` adds `iters` per call. The last mask head and the
        convex upsampling lie outside both."""
        B = image1.shape[0]
        dev = image1.device
        with profiling.span("flow.encode", device=dev):
            imgs = torch.cat([image1, image2], dim=0).permute(0, 3, 1, 2)
            imgs = 2.0 * (imgs / 255.0) - 1.0
            fmaps = self.fnet(imgs)
            cnet = self.cnet(imgs[:B])
            net = torch.tanh(cnet[:, : self.hidden_dim])
            inp = F.relu(cnet[:, self.hidden_dim:])

            pyramid = build_corr_pyramid(fmaps[:B], fmaps[B:], self.num_levels)
            del fmaps
        H8, W8 = net.shape[-2:]
        ys, xs = torch.meshgrid(
            torch.arange(H8, dtype=net.dtype, device=net.device),
            torch.arange(W8, dtype=net.dtype, device=net.device),
            indexing="ij",
        )
        coords0 = torch.stack([xs, ys], dim=0).expand(B, 2, H8, W8)

        def step(net, coords1):
            pts = coords1.permute(0, 2, 3, 1).reshape(B, H8 * W8, 2).contiguous()
            corr = self.lookup(pyramid, pts, self.radius)        # [B, P, L*K]
            corr = corr.view(B, H8, W8, -1).permute(0, 3, 1, 2)
            net, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
            if all_iters:
                return net, coords1, upsample_flow_convex(coords1 - coords0,
                                                          self.update_block.mask(net))
            return net, coords1, None

        coords1, ups = coords0, []
        with profiling.span("flow.update", device=dev):
            profiling.count("flow.gru_iters", iters)
            for _ in range(iters):
                if self.remat and torch.is_grad_enabled():
                    net, coords1, up = checkpoint(step, net, coords1, use_reentrant=False)
                else:
                    net, coords1, up = step(net, coords1)
                ups.append(up)
        if all_iters:
            return torch.stack(ups, dim=1).permute(0, 1, 3, 4, 2)
        # only the last iteration's mask is used (raft.py:370)
        up = upsample_flow_convex(coords1 - coords0, self.update_block.mask(net))
        return up.permute(0, 2, 3, 1)


def compact_raft(remat: bool = False) -> RAFT:
    """The small configuration of the repo's checkpoint (raft.py:373)."""
    return RAFT(
        hidden_dim=64,
        context_dim=64,
        enc_dim=128,
        enc_base=32,
        motion_dims=(96, 64, 48, 32, 64),
        head_hidden=128,
        mask_hidden=128,
        cnet_norm="instance",
        remat=remat,
    )
