"""Shared-focal self-calibration from fundamental matrices
(port of particlesfm_tpu/globalsfm/selfcal.py).

1. batched fundamental-matrix RANSAC over all pairs in lockstep (fixed
   hypothesis budget, rank-2 F);
2. a 1-D log-grid search over candidate focals minimizing the
   Mendonca-Cipolla essentiality cost c_p(f) = (s1 - s2) / (s1 + s2) of
   E_p(f) = K(f)^T F_p K(f); per-pair curves are normalized by their own
   median, aggregated by inlier-weighted mean and refined with a 3-point
   parabola in log f. Pairs a homography explains down to the noise floor
   are excluded (their F dips at a consistent wrong focal).

Everything is flat-batched 3x3 closed-form algebra (geometry/linalg3) on the
inputs' device. The 8-point and DLT normal matrices and the cost curves are
computed in float64 where the reference uses float32: there the result hangs
on rounding (the card and the CPU gave focals 4.5e-3 apart from the same
draws on the 48-frame protocol sequence), in float64 it does not. RANSAC
draws are injectable (`u_f` [P, S, 8], `u_h`
[P, 32, 4]) so the reference's draws reproduce its hypotheses; otherwise
they come from a `torch.Generator` seeded with `seed` on that device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import epipolar
from ..geometry.homography import homography_ransac, symmetric_transfer_error
from ..geometry.linalg3 import eigh3x3_desc
from ..ops.sampling import bilinear_sample
from .twoview import (sample_indices, threefry_key, threefry_split, threefry_uniform,
                      uniform_draws)


class FundamentalResult(NamedTuple):
    F: torch.Tensor            # [P, 3, 3] pixel-coordinate fundamental matrices
    inliers: torch.Tensor      # [P, M] bool
    num_inliers: torch.Tensor  # [P] int32


class FocalEstimate(NamedTuple):
    focal: torch.Tensor        # [] estimated shared focal (pixels)
    confidence: torch.Tensor   # [] fraction of informative pairs agreeing within 20%
    num_pairs: torch.Tensor    # [] informative pairs
    curve: torch.Tensor        # [C] aggregated cost curve
    f_grid: torch.Tensor       # [C] candidate focals


def estimate_fundamentals(uv1, uv2, mask, thres_px_sq: float, num_hypotheses: int = 64,
                          u=None, generator=None) -> FundamentalResult:
    """Fixed-budget fundamental-matrix RANSAC for all pairs at once.

    uv1, uv2: [P, M, 2] raw pixel coords; mask [P, M] bool; u: optional
    injected draws [P, num_hypotheses, 8]."""
    P, M, _ = uv1.shape
    S = num_hypotheses
    u = uniform_draws((P, S, 8), u, generator, uv1.device)
    idx = sample_indices(u, mask)                                   # [P, S, 8]
    rows = torch.arange(P, device=uv1.device)[:, None, None]
    F0 = epipolar.eight_point(
        uv1[rows, idx].reshape(P * S, 8, 2), uv2[rows, idx].reshape(P * S, 8, 2),
        mask[rows, idx].to(uv1.dtype).reshape(P * S, 8)).reshape(P, S, 3, 3)
    err = epipolar.sampson_error(F0, uv1[:, None], uv2[:, None])   # [P, S, M]
    inl = (err < thres_px_sq) & mask[:, None]
    best = torch.argmax(inl.sum(-1), dim=-1)
    ar = torch.arange(P, device=uv1.device)
    best_inl = inl[ar, best]
    F_best = F0[ar, best]
    # one masked LS refit on the winning consensus set
    F_refit = epipolar.eight_point(uv1, uv2, best_inl.to(uv1.dtype))
    inl_refit = (epipolar.sampson_error(F_refit, uv1, uv2) < thres_px_sq) & mask
    better = inl_refit.sum(-1) >= best_inl.sum(-1)
    F_final = torch.where(better[:, None, None], F_refit, F_best)
    inl_final = torch.where(better[:, None], inl_refit, best_inl)
    return FundamentalResult(F_final, inl_final, inl_final.sum(-1).to(torch.int32))


def focal_cost_curves(F: torch.Tensor, pp: torch.Tensor, f_grid: torch.Tensor) -> torch.Tensor:
    """Mendonca-Cipolla essentiality cost for every (pair, candidate): [P, C].

    Computed in float64 and returned in F's dtype: at the dip s1 ~ s2, where
    the closed-form eigenvalues of E^T E lose ~sqrt(eps), so in float32 the
    curve's minimum would depend on the device's rounding."""
    P, C = F.shape[0], f_grid.shape[0]
    K = torch.zeros((C, 3, 3), dtype=torch.float64, device=F.device)
    K[:, 0, 0] = f_grid
    K[:, 1, 1] = f_grid
    K[:, 0, 2] = pp[0]
    K[:, 1, 2] = pp[1]
    K[:, 2, 2] = 1.0
    E = K.transpose(-1, -2)[None] @ F.double()[:, None] @ K[None]  # [P, C, 3, 3]
    E = E.reshape(P * C, 3, 3)
    w, _ = eigh3x3_desc(E.transpose(-1, -2) @ E)                   # descending
    s = torch.sqrt(torch.clamp(w, min=0.0)).reshape(P, C, 3)
    return ((s[..., 0] - s[..., 1]) / torch.clamp(s[..., 0] + s[..., 1], min=1e-12)).to(F.dtype)


def _log_grid(f_lo: float, f_hi: float, num: int, device) -> torch.Tensor:
    """exp of `num` points evenly spaced in log f, endpoints exact (the
    arithmetic of jnp.linspace in float32)."""
    lo = torch.log(torch.tensor(f_lo, dtype=torch.float32, device=device))
    hi = torch.log(torch.tensor(f_hi, dtype=torch.float32, device=device))
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    return torch.exp(torch.cat([lo * (1 - step) + hi * step, hi[None]]))


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Row median [P, 1] that averages the two middle values of an even
    count, as jnp.median does (torch.median returns the lower one)."""
    s = torch.sort(x, dim=1).values
    n = x.shape[1]
    if n % 2:
        return s[:, n // 2:n // 2 + 1]
    return (s[:, n // 2 - 1:n // 2] + s[:, n // 2:n // 2 + 1]) * 0.5


def estimate_shared_focal(uv1, uv2, mask, pp, f_lo: float, f_hi: float,
                          thres_px_sq: float = 16.0, min_inliers: int = 24,
                          num_candidates: int = 96, num_hypotheses: int = 64,
                          reject_planar: bool = True, u_f=None, u_h=None,
                          seed: int = 0) -> FocalEstimate:
    """Estimate the shared focal length from pixel correspondences alone.

    uv1, uv2: [P, M, 2] raw pixel coords; mask [P, M] bool; pp: (cx, cy).
    u_f [P, num_hypotheses, 8] / u_h [P, 32, 4]: optional injected draws of
    the F- and H-RANSAC; missing ones come from a generator seeded with
    `seed` on the inputs' device.

    `reject_planar`: pairs a homography explains down to the noise floor
    carry no focal signal but agree with each other (their F collapses to the
    degenerate [e]x.H family), so they are excluded. The tight criterion
    (thres/16) keeps ordinary small-baseline pairs, which are loosely
    H-explainable but not tightly.
    """
    dev, dt = uv1.device, uv1.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    fr = estimate_fundamentals(uv1, uv2, mask, thres_px_sq, num_hypotheses, u_f, gen)
    f_grid = _log_grid(f_lo, f_hi, num_candidates, dev).to(dt)
    pp = torch.as_tensor(pp, dtype=dt, device=dev)
    curves = focal_cost_curves(fr.F, pp, f_grid)                   # [P, C]

    n_in = fr.num_inliers.to(dt)
    w_pair = torch.where(fr.num_inliers >= min_inliers, torch.sqrt(n_in),
                         torch.zeros_like(n_in))
    if reject_planar:
        H, _, num_h = homography_ransac(
            uv1, uv2, mask, torch.full((uv1.shape[0],), thres_px_sq, dtype=dt, device=dev),
            num_hypotheses=32, u=u_h, generator=gen)
        err_h = symmetric_transfer_error(H, uv1, uv2)
        num_h_tight = ((err_h < thres_px_sq / 16.0) & mask).sum(-1).to(dt)
        num_h = num_h.to(dt)
        planar = ((num_h >= 0.85 * torch.clamp(n_in, min=1.0))
                  & (num_h_tight > 0.5 * torch.clamp(num_h, min=1.0)))
        w_pair = torch.where(planar, torch.zeros_like(w_pair), w_pair)
    # self-normalize each pair's curve: a flat (degenerate-geometry) curve
    # becomes ~1 everywhere; informative pairs contribute a dip at the focal
    med = _median_rows(curves)
    norm_curves = curves / torch.clamp(med, min=1e-9)
    agg = (norm_curves * w_pair[:, None]).sum(0) / torch.clamp(w_pair.sum(), min=1e-9)

    C = num_candidates
    i = torch.argmin(agg)
    im = torch.clamp(i - 1, 0, C - 1)
    ip = torch.clamp(i + 1, 0, C - 1)
    # 3-point parabola in log f (uniform log grid)
    ym, y0, yp = agg[im], agg[i], agg[ip]
    denom = ym - 2.0 * y0 + yp
    shift = torch.where(denom.abs() > 1e-12,
                        torch.clamp(0.5 * (ym - yp) / torch.clamp(denom, min=1e-12), -1.0, 1.0),
                        torch.zeros_like(denom))
    interior = (i > 0) & (i < C - 1)
    shift = torch.where(interior, shift, torch.zeros_like(shift))
    step = (np.log(np.float32(f_hi)) - np.log(np.float32(f_lo))) / (C - 1)
    f_hat = torch.exp(torch.log(f_grid[i]) + shift * float(step))

    # agreement confidence: informative pairs (enough inliers and a real dip,
    # min < 0.7 * own median) whose own minimum lies within 20% of f_hat
    per_min_i = torch.argmin(curves, dim=1)
    per_f = f_grid[per_min_i]
    per_depth = torch.gather(curves, 1, per_min_i[:, None])[:, 0]
    informative = (w_pair > 0) & (per_depth < 0.7 * torch.clamp(med[:, 0], min=1e-9))
    agree = informative & (torch.log(per_f / f_hat).abs() < 0.18)
    n_inf = informative.sum()
    conf = agree.sum().to(dt) / torch.clamp(n_inf.to(dt), min=1.0)
    conf = torch.where(n_inf >= 8, conf, torch.zeros_like(conf))
    return FocalEstimate(f_hat, conf, n_inf.to(torch.int32), agg, f_grid)


def reference_draws(seed: int, num_pairs: int, num_hypotheses: int = 64):
    """The RANSAC draws the reference's estimate_shared_focal makes under
    `jax.random.PRNGKey(seed)` (F-RANSAC under split(key, P), the planar
    check's H-RANSAC under split(split(key)[0], P)), as (u_f [P, S, 8],
    u_h [P, 32, 4]) float32 tensors on the CPU."""
    key = threefry_key(seed)
    u_f = threefry_uniform(threefry_split(key, num_pairs), (num_hypotheses, 8))
    u_h = threefry_uniform(threefry_split(threefry_split(key, 2)[0], num_pairs), (32, 4))
    return torch.from_numpy(u_f), torch.from_numpy(u_h)


def num_selfcal_pairs(num_flow_pairs: int, compose_strides=(2, 4)) -> int:
    """Pairs estimate_focal_from_flows builds from `num_flow_pairs` stride-1
    flow pairs: one per start frame and stride."""
    return sum(max(num_flow_pairs - K + 1, 0) for K in compose_strides)


def flow_correspondences(flows: dict, height: int, width: int, seed: int = 0,
                         grid_step: int = 10, max_points: int = 2048,
                         compose_strides=(2, 4), fb_thresh_px: float = 0.5):
    """Tracker-free correspondences from dense flow: a grid (subsampled with
    numpy's `default_rng(seed)`, as the reference does) chained through the
    forward flow over each of `compose_strides` steps, with a
    forward-backward consistency gate at every hop.

    flows["flow_f"] and flows["flow_b"] ([P, H, W, 2] tensors or arrays) stay
    on their device. Returns (uv1, uv2, ok) [Q, M, 2], [Q, M, 2], [Q, M] on
    that device, Q = `num_selfcal_pairs(P)`; None when the image is too small
    to carry a focal signal.
    """
    rng = np.random.default_rng(seed)
    mx = min(24, max(2, width // 8))
    my = min(24, max(2, height // 8))
    xs = np.arange(mx, width - mx, grid_step)
    ys = np.arange(my, height - my, grid_step)
    gx, gy = np.meshgrid(xs, ys)
    grid = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    if len(grid) < 64:
        return None
    if len(grid) > max_points:
        grid = grid[rng.choice(len(grid), max_points, replace=False)]

    ff = torch.as_tensor(flows["flow_f"])
    fb = torch.as_tensor(flows["flow_b"], device=ff.device)
    dev = ff.device
    grid_d = torch.from_numpy(grid).to(dev)
    T = ff.shape[0]
    uv1s, uv2s, oks = [], [], []
    for K in compose_strides:
        nw = T - K + 1
        if nw < 1:
            continue
        p = grid_d.expand(nw, -1, -1)
        ok = torch.ones(p.shape[:2], dtype=torch.bool, device=dev)
        for k in range(K):           # fb-gated hop k of every window at once
            f = bilinear_sample(ff[k:k + nw], p)
            pn = p + f
            b = bilinear_sample(fb[k:k + nw], pn)
            ok = ok & (torch.linalg.vector_norm(f + b, dim=-1) < fb_thresh_px) & (
                (pn[..., 0] > 4) & (pn[..., 0] < width - 4)
                & (pn[..., 1] > 4) & (pn[..., 1] < height - 4))
            p = pn
        uv1s.append(grid_d.expand(nw, -1, -1))
        uv2s.append(p)
        oks.append(ok)
    return torch.cat(uv1s), torch.cat(uv2s), torch.cat(oks)


def estimate_focal_from_flows(flows: dict, height: int, width: int, seed: int = 0,
                              grid_step: int = 10, max_points: int = 2048,
                              thres_px_sq: float = 4.0, compose_strides=(2, 4),
                              fb_thresh_px: float = 0.5, u_f=None, u_h=None) -> dict:
    """Shared-focal self-calibration from dense flow fields:
    `estimate_shared_focal` on `flow_correspondences`.

    u_f / u_h: optional injected RANSAC draws (see `estimate_shared_focal`;
    P = `num_selfcal_pairs(len(flows["flow_f"]))`).

    Returns a JSON-ready dict {focal, confidence, num_pairs, dip, interior};
    `dip` is the aggregated curve's min/median contrast (< ~0.5 means a real
    minimum), `interior` False flags a boundary minimum.
    """
    corr = flow_correspondences(flows, height, width, seed, grid_step, max_points,
                                compose_strides, fb_thresh_px)
    if corr is None:  # image too small to carry a focal signal
        return {"focal": float(max(height, width)), "confidence": 0.0,
                "num_pairs": 0, "dip": 1.0, "interior": False}
    uv1, uv2, ok = corr
    est = estimate_shared_focal(
        uv1, uv2, ok, (width / 2.0, height / 2.0),
        0.3 * max(height, width), 3.0 * max(height, width),
        thres_px_sq=thres_px_sq, u_f=u_f, u_h=u_h, seed=seed)
    curve = est.curve.cpu().numpy()
    f_grid = est.f_grid.cpu().numpy()
    focal = float(est.focal)
    return {
        "focal": focal,
        "confidence": float(est.confidence),
        "num_pairs": int(est.num_pairs),
        "dip": float(curve.min() / max(float(np.median(curve)), 1e-9)),
        # a minimum at the grid boundary is not a minimum: reject downstream
        "interior": bool(f_grid[1] < focal < f_grid[-2]),
    }
