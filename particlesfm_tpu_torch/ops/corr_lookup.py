"""RAFT's windowed correlation-pyramid lookup: CUDA kernel K1 + plain version.

Port of the Pallas TPU kernel particlesfm_tpu/ops/corr_lookup.py
(`lookup_corr_pyramid_pallas`), computing the gather form
particlesfm_tpu/models/raft.py:101 (`lookup_corr_gather`) batched over pairs.
The kernel source is `csrc/corr_lookup.cu`; it is compiled with nvcc for
sm_90a into `_build/` the first time a CUDA tensor reaches `lookup_corr`
(`ops/nvcc.py`), and bound with ctypes (plain C interface: no torch headers,
a build of seconds).

Dispatch: tensors on the CPU take the plain version (`lookup_corr_plain`);
tensors on CUDA always launch the kernel — a failed build or launch raises,
there is no fallback. The kernel is compiled for radius 1..4 and 1..4 levels
(`RADII`, `MAX_LEVELS`); any other shape raises `ValueError` on CUDA.
`launches` counts kernel launches, `vec_launches` those that copied the
windows in 16-byte chunks. `lookup_bytes` is the byte count of the kernel's
bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import nvcc

SOURCE = nvcc.CSRC / "corr_lookup.cu"
MAX_LEVELS = 4
RADII = (1, 2, 3, 4)    # the radii the kernel is compiled for

launches = 0            # kernel launches since import (or the last reset)
vec_launches = 0        # those of them that copied windows in 16-byte chunks


def reset_launches() -> None:
    global launches, vec_launches
    launches = vec_launches = 0


def lookup_corr_plain(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Plain PyTorch lookup: per-corner gathers with validity masks.

    pyramid: list of [B, P, Hl, Wl] per-pixel correlation maps; coords:
    [B, P, 2] (x, y) at level-0 scale. Returns [B, P, L*(2r+1)^2] ordered
    level, then dy, then dx (raft.py:106-111,207)."""
    B, P = coords.shape[:2]
    r = radius
    d = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], dim=-1).reshape(-1, 2)           # [K, 2]
    rows = torch.arange(B * P, device=coords.device).view(B, P, 1)
    out = []
    for lvl, corr in enumerate(pyramid):
        Hl, Wl = corr.shape[-2:]
        flat = corr.reshape(B * P, Hl * Wl)
        pts = coords.view(B, P, 1, 2) / (2.0 ** lvl) + delta       # [B, P, K, 2]
        x = pts[..., 0]
        y = pts[..., 1]
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx = x - x0
        wy = y - y0
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)

        def gather(yi, xi):
            valid = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
            v = flat[rows, yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)]
            return v * valid.to(corr.dtype)

        out.append(
            (1 - wx) * (1 - wy) * gather(y0i, x0i)
            + wx * (1 - wy) * gather(y0i, x0i + 1)
            + (1 - wx) * wy * gather(y0i + 1, x0i)
            + wx * wy * gather(y0i + 1, x0i + 1)
        )
    return torch.cat(out, dim=-1)


def lookup_bytes(shapes, coords: torch.Tensor, radius: int = 4) -> int:
    """Bytes a lookup must move for these coordinates: the output written
    once, the coordinates read once, and each pixel's (2r+2)^2 window per
    level read once where it lies inside the map.

    shapes: the levels' (Hl, Wl); coords: [B, P, 2] (x, y) at level-0 scale.
    The window of a level starts at floor(coords / 2^l) - r."""
    B, P = coords.shape[:2]
    r = radius
    window_elems = 0
    for lvl, (Hl, Wl) in enumerate(shapes):
        pt = coords.double() / 2 ** lvl
        n = []
        for c, size in ((pt[..., 0], Wl), (pt[..., 1], Hl)):
            lo = torch.floor(c).clamp(-1e9, 1e9).long() - r
            hi = lo + 2 * r + 1
            n.append((hi.clamp(max=size - 1) - lo.clamp(min=0) + 1).clamp(min=0))
        window_elems += int((n[0] * n[1]).sum())
    n_out = B * P * len(shapes) * (2 * r + 1) ** 2
    return 4 * (n_out + B * P * 2 + window_elems)


def load_library():
    """Build (first use) and load the kernel library."""
    return nvcc.load(SOURCE, "corr_lookup_launch",
                     [ctypes.c_void_p] * MAX_LEVELS + [ctypes.c_int] * (2 * MAX_LEVELS)
                     + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int)])


def lookup_corr_cuda(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Launch kernel K1 on CUDA tensors (same contract as lookup_corr_plain).
    Pyramids whose levels all have 16-byte aligned rows (Wl % 4 == 0) are
    copied in 16-byte chunks, any other shape in 4-byte elements."""
    global launches, vec_launches
    L = len(pyramid)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"corr_lookup: 1..{MAX_LEVELS} levels, got {L}")
    if radius not in RADII:
        raise ValueError(f"corr_lookup: the kernel takes radius {RADII}, got {radius}")
    B, P = coords.shape[:2]
    if coords.shape != (B, P, 2) or coords.dtype != torch.float32 or not coords.is_cuda \
            or not coords.is_contiguous() or coords.data_ptr() % 8:
        raise ValueError("corr_lookup: coords must be contiguous, 8-byte aligned float32 "
                         "[B, P, 2] on CUDA")
    for c in pyramid:
        if c.dim() != 4 or c.shape[:2] != (B, P) or c.dtype != torch.float32 \
                or c.device != coords.device or not c.is_contiguous():
            raise ValueError(
                "corr_lookup: levels must be contiguous float32 [B, P, Hl, Wl] "
                "on the device of coords")
    K = (2 * radius + 1) ** 2
    out = torch.empty(B, P, L * K, dtype=torch.float32, device=coords.device)
    fn = load_library().corr_lookup_launch
    pad = MAX_LEVELS - L
    ptrs = [c.data_ptr() for c in pyramid] + [None] * pad
    hw = []
    for c in pyramid:
        hw += [c.shape[2], c.shape[3]]
    hw += [0, 0] * pad
    used_vec = ctypes.c_int()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, *hw, L, coords.data_ptr(), out.data_ptr(), B * P, radius, stream,
                coords.device.index, ctypes.byref(used_vec))
    if rc != 0:
        raise RuntimeError(f"corr_lookup: kernel launch failed (cudaError {rc})")
    launches += 1
    vec_launches += used_vec.value
    return out


def lookup_corr(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Windowed lookup; CPU tensors take the plain version, CUDA tensors K1."""
    if coords.device.type == "cpu":
        return lookup_corr_plain(pyramid, coords, radius)
    if coords.device.type == "cuda":
        return lookup_corr_cuda(pyramid, coords, radius)
    raise ValueError(f"corr_lookup: unsupported device {coords.device}")
