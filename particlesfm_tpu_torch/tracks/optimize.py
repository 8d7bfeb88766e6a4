"""Path-consistency trajectory optimization as batched Levenberg-Marquardt
(port of particlesfm_tpu/tracks/optimize.py).

Per trajectory a 4-dof block p = (x1, y1, x2, y2) with 6 residuals (upstream
ParticleSfM's Ceres cost, point_trajectory/optimize/src/path_consistency_cost.h):

    r0,r1 = (x1,y1) - uv_ref1                    # stride-1 flow anchor
    r2,r3 = ((x2,y2) - uv_ref2) * ref2_scale     # stride-2 flow anchor
    r4,r5 = (x2,y2) - (x1,y1) - flow12(x1,y1)    # path consistency via bilinear map

The problem is block-diagonal across trajectories: every solve is a
closed-form 4x4 Cholesky over the whole batch, in elementwise tensor ops.
flow12 is sampled with edge-clamped bilinear interpolation (Ceres Grid2D).

`track_lm` is the tracker's whole refinement step for one frame (its anchor
samples, the LM and the write-back). CPU tensors take the plain version
(`track_lm_plain`: these torch ops, the oracle); CUDA tensors always launch
kernel K2 (`csrc/track_lm.cu`, built by `ops/nvcc.py` on first use and bound
with ctypes): a failed build, launch or argument check raises, there is no
fallback. `launches` counts K2's launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import nvcc
from ..ops.sampling import bilinear_sample
from ..utils import profiling

_PATCH = 6  # local flow window per trajectory: +-2 px of refinement travel
SOURCE = nvcc.CSRC / "track_lm.cu"
NVCC_FLAGS = ("-fmad=false",)   # one rounding per op, as the torch ops round

launches = 0            # K2 launches since import (or the last reset)


def reset_launches() -> None:
    global launches
    launches = 0


def _sample_flow_and_jac(flow_map: torch.Tensor, xy: torch.Tensor):
    """Edge-clamped bilinear sample of flow_map [H, W, 2] at xy [N, 2] ->
    (flow [N, 2], jac [N, 2, 2] = d flow / d xy), the exact piecewise-constant
    derivative of the interpolant."""
    H, W, _ = flow_map.shape
    x = xy[..., 0].clamp(0.0, W - 1.0)
    y = xy[..., 1].clamp(0.0, H - 1.0)
    x0 = torch.floor(x).clamp(0, W - 2).to(torch.int64)
    y0 = torch.floor(y).clamp(0, H - 2).to(torch.int64)
    flat = flow_map.reshape(H * W, 2)
    return _interp(flat[y0 * W + x0], flat[y0 * W + x0 + 1], flat[(y0 + 1) * W + x0],
                   flat[(y0 + 1) * W + x0 + 1], x - x0.to(x.dtype), y - y0.to(y.dtype),
                   xy, H, W)


def _interp(f00, f01, f10, f11, dx, dy, xy, height, width):
    """Bilinear value + Jacobian from the four corners of each point's cell;
    the Jacobian is zero in a direction where xy is clamped."""
    dx = dx[..., None]
    dy = dy[..., None]
    top = f00 + dx * (f01 - f00)
    bot = f10 + dx * (f11 - f10)
    val = top + dy * (bot - top)
    dfdx = (1 - dy) * (f01 - f00) + dy * (f11 - f10)
    dfdy = bot - top
    jac = torch.stack([dfdx, dfdy], dim=-1)          # [N, 2(channel), 2(x, y)]
    inx = (xy[..., 0] >= 0.0) & (xy[..., 0] <= width - 1.0)
    iny = (xy[..., 1] >= 0.0) & (xy[..., 1] <= height - 1.0)
    gate = torch.stack([inx, iny], dim=-1)[..., None, :].to(val.dtype)
    return val, jac * gate


def _extract_patches(flow_map: torch.Tensor, xy: torch.Tensor):
    """Gather a [P, P, 2] window of flow_map [H, W, 2] around each xy [N, 2].

    Returns (patch [N, P, P, 2], ps [N, 2] int64 window origin). Windows are
    clipped fully inside the image."""
    H, W, _ = flow_map.shape
    P = _PATCH
    px = (torch.floor(xy[..., 0]).to(torch.int64) - (P // 2 - 1)).clamp(0, W - P)
    py = (torch.floor(xy[..., 1]).to(torch.int64) - (P // 2 - 1)).clamp(0, H - P)
    ar = torch.arange(P, device=xy.device)
    lin = (py[:, None] + ar)[:, :, None] * W + (px[:, None] + ar)[:, None, :]
    patch = flow_map.reshape(H * W, 2)[lin]
    return patch, torch.stack([px, py], dim=-1)


def _patch_sample_and_jac(patch, ps, xy, height, width):
    """Bilinear sample + Jacobian from per-point patches (optimize.py:78).

    The 2x2 interpolation cell is picked inside each point's patch, so the LM
    loop never reads the full map. Same result as _sample_flow_and_jac
    wherever the point stays within its window; beyond it the window
    edge-clamps."""
    P = _PATCH
    x = (xy[..., 0].clamp(0.0, width - 1.0) - ps[..., 0].to(xy.dtype)).clamp(0.0, P - 1.0)
    y = (xy[..., 1].clamp(0.0, height - 1.0) - ps[..., 1].to(xy.dtype)).clamp(0.0, P - 1.0)
    x0 = torch.floor(x).clamp(0, P - 2).to(torch.int64)
    y0 = torch.floor(y).clamp(0, P - 2).to(torch.int64)
    flat = patch.reshape(-1, P * P, 2)

    def at(iy, ix):
        return torch.gather(flat, 1, (iy * P + ix)[:, None, None].expand(-1, 1, 2))[:, 0]

    return _interp(at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0), at(y0 + 1, x0 + 1),
                   x - x0.to(x.dtype), y - y0.to(y.dtype), xy, height, width)


def path_consistency_residuals(p, uv_ref1, uv_ref2, ref2_scale, flow12_map,
                               sample_fn=None):
    """Residuals r [N, 6] and Jacobian J [N, 6, 4] for blocks p [N, 4]."""
    x1 = p[..., 0:2]
    x2 = p[..., 2:4]
    if sample_fn is None:
        f12, jf = _sample_flow_and_jac(flow12_map, x1)
    else:
        f12, jf = sample_fn(x1)
    r01 = x1 - uv_ref1
    r02 = (x2 - uv_ref2) * ref2_scale[..., None]
    r12 = (x2 - x1) - f12
    r = torch.cat([r01, r02, r12], dim=-1)

    e = torch.eye(2, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (2, 2))
    z = torch.zeros_like(e)
    s = ref2_scale[..., None, None] * e
    J_top = torch.cat([e, z], dim=-1)                # d r01 / d(x1, x2)
    J_mid = torch.cat([z, s], dim=-1)                # d r02
    J_bot = torch.cat([-e - jf, e], dim=-1)          # d r12
    return r, torch.cat([J_top, J_mid, J_bot], dim=-2)


def _solve4_spd(H, g):
    """Batched 4x4 SPD solve via explicit Cholesky in elementwise ops.
    H: [N, 4, 4], g: [N, 4] -> x with H x = g."""
    eps = 1e-20

    def at(i, j):
        return H[..., i, j]

    def sqrt_pos(v):
        return torch.sqrt(torch.clamp(v, min=eps))

    l00 = sqrt_pos(at(0, 0))
    l10 = at(1, 0) / l00
    l20 = at(2, 0) / l00
    l30 = at(3, 0) / l00
    l11 = sqrt_pos(at(1, 1) - l10 * l10)
    l21 = (at(2, 1) - l20 * l10) / l11
    l31 = (at(3, 1) - l30 * l10) / l11
    l22 = sqrt_pos(at(2, 2) - l20 * l20 - l21 * l21)
    l32 = (at(3, 2) - l30 * l20 - l31 * l21) / l22
    l33 = sqrt_pos(at(3, 3) - l30 * l30 - l31 * l31 - l32 * l32)
    # forward substitution L y = g
    y0 = g[..., 0] / l00
    y1 = (g[..., 1] - l10 * y0) / l11
    y2 = (g[..., 2] - l20 * y0 - l21 * y1) / l22
    y3 = (g[..., 3] - l30 * y0 - l31 * y1 - l32 * y2) / l33
    # back substitution L^T x = y
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) / l00
    return torch.stack([x0, x1, x2, x3], dim=-1)


def _sum_residuals(a, b):
    """sum_k a[:, k] * b[:, k] over the residual axis (dim 1), as a chain of
    multiply-adds in residual order: the order of XLA's dot_general on the
    CPU, so the LM's accept/reject decisions stay in step with the reference
    instead of flipping on last-bit differences near convergence."""
    acc = a[:, 0] * b[:, 0]
    for k in range(1, a.shape[1]):
        acc = torch.addcmul(acc, a[:, k], b[:, k])
    return acc


def optimize_locations(uv12, uv_ref1, uv_ref2, ref2_scale, flow12_map, mask=None,
                       num_iters: int = 20, patch: bool = False) -> torch.Tensor:
    """Batched single-evaluation LM solve of the path-consistency problem.

    uv12: [N, 4] initial (x1,y1,x2,y2); uv_ref1/uv_ref2: [N, 2]; ref2_scale:
    [N]; flow12_map: [H, W, 2]; mask: [N] (rows with 0 pass through). With
    `patch`, the flow map is gathered once into per-point 6x6 windows that
    every iteration samples from. Returns optimized [N, 4]."""
    if mask is None:
        mask = torch.ones(uv12.shape[:-1], dtype=uv12.dtype, device=uv12.device)
    mask = mask.to(uv12.dtype)

    sample_fn = None
    if patch:
        H, W, _ = flow12_map.shape
        patches, ps = _extract_patches(flow12_map, uv12[..., 0:2])
        sample_fn = lambda x1: _patch_sample_and_jac(patches, ps, x1, H, W)  # noqa: E731

    def eval_model(p):
        r, J = path_consistency_residuals(p, uv_ref1, uv_ref2, ref2_scale,
                                          flow12_map, sample_fn)
        cost = sum(r[..., k] * r[..., k] for k in range(r.shape[-1]))
        g = _sum_residuals(J, r[..., None])                           # J^T r
        Hs = _sum_residuals(J[..., :, :, None], J[..., :, None, :])   # J^T J
        return cost, g, Hs

    # the carry holds the best point's gradient/Hessian: a rejected step
    # re-proposes from the stored model with larger damping
    p_best = uv12
    cost_best, g, Hs = eval_model(uv12)
    lam = torch.full(uv12.shape[:-1], 1e-4, dtype=uv12.dtype, device=uv12.device)
    eye = torch.eye(4, dtype=uv12.dtype, device=uv12.device)
    for _ in range(num_iters):
        p_cand = p_best + _solve4_spd(Hs + lam[..., None, None] * eye, -g)
        cost_c, g_c, H_c = eval_model(p_cand)
        better = cost_c < cost_best
        p_best = torch.where(better[..., None], p_cand, p_best)
        cost_best = torch.where(better, cost_c, cost_best)
        g = torch.where(better[..., None], g_c, g)
        Hs = torch.where(better[..., None, None], H_c, Hs)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 4.0), 1e-8, 1e6)
    return torch.where(mask[..., None] > 0, p_best, uv12)


def track_lm_plain(flow12, flow01, flow02, occ02, prev2, prev1, new_pos, survive,
                   start_time, f: int, upper_flow: float, num_iters: int,
                   patch: bool) -> None:
    """Step 4 of the tracker's frame f in torch ops: the slots with
    `survive & (start_time <= f - 1)` refine their positions at f and f+1
    (prev1, new_pos [C, 2], updated in place) against the anchors at their
    position at f-1 (prev2): flow01 = flows[f-1], flow02 = flows2[f-1] and
    occ02 = occs2[f-1] sampled there; flow12 = flows[f] between them."""
    eligible = survive & (start_time <= f - 1)
    x0 = prev2
    f01 = bilinear_sample(flow01, x0)
    f02 = bilinear_sample(flow02, x0)
    o02 = bilinear_sample(occ02[..., None], x0)[..., 0]
    uv_ref1 = x0 + f01
    uv_ref2 = x0 + f02
    f02_norm = torch.sqrt((f02 * f02).sum(-1))
    scale = (1.0 - o02) * (f02_norm < upper_flow).to(o02.dtype)
    p = torch.cat([prev1, new_pos], dim=-1)
    p_opt = optimize_locations(
        p, uv_ref1, uv_ref2, scale, flow12,
        mask=eligible.to(p.dtype), num_iters=num_iters, patch=patch)
    e2 = eligible[:, None]
    prev1.copy_(torch.where(e2, p_opt[:, 0:2], prev1))
    new_pos.copy_(torch.where(e2, p_opt[:, 2:4], new_pos))


def _check(flow12, flow01, flow02, occ02, prev2, prev1, new_pos, survive, start_time,
           num_iters: int, patch: bool) -> None:
    """What K2 takes: contiguous float32 maps [H, W, 2] (occ02 [H, W]) and
    slots [C, 2], survive bool [C], start_time int32 [C], all on one CUDA
    device; maps and slots 8-byte aligned; num_iters >= 0; H, W >= 6 with
    `patch` (the window lies inside the image), >= 2 without."""
    maps = (flow12, flow01, flow02)
    slots = (prev2, prev1, new_pos)
    H, W = flow12.shape[:2]
    C = prev2.shape[0]
    want = [(t, (H, W, 2), torch.float32) for t in maps] + [(occ02, (H, W), torch.float32)]
    want += [(t, (C, 2), torch.float32) for t in slots]
    want += [(survive, (C,), torch.bool), (start_time, (C,), torch.int32)]
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"track_lm: expected {dtype} {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("track_lm: inputs must be contiguous")
    if any(t.data_ptr() % 8 for t in maps + slots):
        raise ValueError("track_lm: maps and slots must be 8-byte aligned")
    if num_iters < 0 or min(H, W) < (_PATCH if patch else 2):
        raise ValueError(f"track_lm: num_iters {num_iters}, map {H}x{W} (patch={patch})")
    dev = flow12.device
    if dev.type != "cuda" or any(t.device != dev for t, _, _ in want):
        raise ValueError("track_lm: inputs must lie on one CUDA device")


def load_library():
    """Build (first use) and load K2's library."""
    return nvcc.load(SOURCE, "track_lm_launch",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2
                     + [ctypes.c_void_p], NVCC_FLAGS)


def track_lm_cuda(flow12, flow01, flow02, occ02, prev2, prev1, new_pos, survive,
                  start_time, f: int, upper_flow: float, num_iters: int,
                  patch: bool) -> None:
    """Launch K2 on CUDA tensors (same contract as track_lm_plain), on the
    current stream: no synchronisation, no allocation."""
    global launches
    _check(flow12, flow01, flow02, occ02, prev2, prev1, new_pos, survive, start_time,
           num_iters, patch)
    H, W = flow12.shape[:2]
    fn = load_library().track_lm_launch
    with torch.cuda.device(flow12.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(flow12.data_ptr(), flow01.data_ptr(), flow02.data_ptr(), occ02.data_ptr(),
                H, W, prev2.data_ptr(), prev1.data_ptr(), new_pos.data_ptr(),
                survive.data_ptr(), start_time.data_ptr(), prev2.shape[0], f, upper_flow,
                num_iters, int(patch), stream)
    if rc != 0:
        raise RuntimeError(f"track_lm: kernel launch failed (cudaError {rc})")
    launches += 1
    profiling.count("tracks.lm_kernel")


def track_lm(flow12, flow01, flow02, occ02, prev2, prev1, new_pos, survive, start_time,
             f: int, upper_flow: float, num_iters: int, patch: bool) -> None:
    """The tracker's refinement step of frame f (track_lm_plain's contract):
    CPU tensors take the plain version, CUDA tensors K2."""
    if prev1.device.type == "cpu":
        fn = track_lm_plain
    elif prev1.device.type == "cuda":
        fn = track_lm_cuda
    else:
        raise ValueError(f"track_lm: unsupported device {prev1.device}")
    fn(flow12, flow01, flow02, occ02, prev2, prev1, new_pos, survive, start_time, f,
       upper_flow, num_iters, patch)
