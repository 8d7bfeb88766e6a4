"""RAFT's windowed correlation-pyramid lookup: CUDA kernel K1 + plain version.

Port of the Pallas TPU kernel particlesfm_tpu/ops/corr_lookup.py
(`lookup_corr_pyramid_pallas`), computing the gather form
particlesfm_tpu/models/raft.py:101 (`lookup_corr_gather`) batched over pairs.
The kernel source is `csrc/corr_lookup.cu`; it is compiled with nvcc for
sm_90a into `_build/` the first time a CUDA tensor reaches `lookup_corr`, and
bound with ctypes (plain C interface: no torch headers, a build of seconds).

Dispatch: tensors on the CPU take the plain version (`lookup_corr_plain`);
tensors on CUDA always launch the kernel — a failed build or launch raises,
there is no fallback. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "corr_lookup.cu"
BUILD_DIR = _PKG / "_build"
MAX_LEVELS = 4

launches = 0            # kernel launches since import (or the last reset)
_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


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


def _build_library() -> Path:
    """Compile csrc/corr_lookup.cu for sm_90a; the file name carries a hash
    of the source, so an edited source is rebuilt."""
    from torch.utils.cpp_extension import CUDA_HOME

    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"corr_lookup_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if so.exists():
        return so
    if CUDA_HOME is None:
        raise RuntimeError("corr_lookup: no CUDA toolkit found to build the kernel")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"),
           "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"corr_lookup: nvcc failed:\n{res.stdout}\n{res.stderr}")
    (BUILD_DIR / (so.stem + ".log")).write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def load_library():
    """Build (first use) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_library()))
            fn = lib.corr_lookup_launch
            fn.argtypes = ([ctypes.c_void_p] * MAX_LEVELS + [ctypes.c_int] * (2 * MAX_LEVELS)
                           + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def lookup_corr_cuda(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Launch kernel K1 on CUDA tensors (same contract as lookup_corr_plain)."""
    global launches
    L = len(pyramid)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"corr_lookup: 1..{MAX_LEVELS} levels, got {L}")
    B, P = coords.shape[:2]
    if coords.shape != (B, P, 2) or coords.dtype != torch.float32 or not coords.is_cuda \
            or not coords.is_contiguous():
        raise ValueError("corr_lookup: coords must be contiguous float32 [B, P, 2] on CUDA")
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
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, *hw, L, coords.data_ptr(), out.data_ptr(), B * P, radius, stream)
    if rc != 0:
        raise RuntimeError(f"corr_lookup: kernel launch failed (cudaError {rc})")
    launches += 1
    return out


def lookup_corr(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Windowed lookup; CPU tensors take the plain version, CUDA tensors K1."""
    if coords.device.type == "cpu":
        return lookup_corr_plain(pyramid, coords, radius)
    if coords.device.type == "cuda":
        return lookup_corr_cuda(pyramid, coords, radius)
    raise ValueError(f"corr_lookup: unsupported device {coords.device}")
