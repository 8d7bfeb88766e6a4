"""Batched two-view geometry: fixed-trial essential RANSAC over all pairs at
once, and the degenerate-configuration classification
(port of particlesfm_tpu/globalsfm/twoview.py).

The uniform draws are an input: callers pass the reference's draws to
reproduce its hypotheses, or draws from a seeded `torch.Generator`. Torch's
generators cannot replay `jax.random` streams; `threefry_split` and
`threefry_uniform` recompute them in numpy (threefry2x32 with JAX's
partitionable counters, its default since JAX 0.5), and `pair_draws` gives
the draws the reference takes from one key for a batch of pairs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import epipolar, rotations as rot

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry2x32 hash of counters (x1, x2) under the key
    (k1, k2); uint32 arrays that broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = x1 ^ ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r)))
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def threefry_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2**32: uint32 [2]."""
    return np.array([0, seed], np.uint32)


def threefry_split(keys: np.ndarray, num: int) -> np.ndarray:
    """`jax.random.split(key, num)` of each key in `keys` [..., 2]:
    uint32 [..., num, 2]."""
    keys = np.asarray(keys, np.uint32)
    count = np.arange(num, dtype=np.uint32)
    b1, b2 = _threefry2x32(keys[..., 0:1], keys[..., 1:2], np.zeros_like(count), count)
    return np.stack([b1, b2], -1)


def threefry_uniform(keys: np.ndarray, shape) -> np.ndarray:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)) of each key in
    `keys` [..., 2]: [..., *shape]."""
    keys = np.asarray(keys, np.uint32)
    count = np.arange(int(np.prod(shape)), dtype=np.uint32)
    b1, b2 = _threefry2x32(keys[..., 0:1], keys[..., 1:2], np.zeros_like(count), count)
    mant = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = mant.view(np.float32) - np.float32(1.0)
    return u.reshape(keys.shape[:-1] + tuple(shape))


def pair_draws(seed: int, num_pairs: int, shape) -> np.ndarray:
    """The draws of `jax.random.split(PRNGKey(seed), num_pairs)` followed by
    one `uniform(k, shape)` per pair: float32 [num_pairs, *shape]."""
    return threefry_uniform(threefry_split(threefry_key(seed), num_pairs), shape)


def sample_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Random indices of valid entries, per pair.

    u: [P, S, k] uniform draws in [0, 1); mask: [P, M] bool. Returns
    [P, S, k] int64 indices into M, each a valid entry of its pair (index 0
    of the valid-first order when a pair has no valid entry)."""
    # valid-first order; stable, as jnp.argsort is, so ties keep index order
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    count = torch.clamp(mask.sum(-1), min=1).to(u.dtype)
    idx = (u * count[:, None, None]).to(torch.int64)
    P = u.shape[0]
    return torch.gather(order, 1, idx.reshape(P, -1)).reshape(idx.shape)


def uniform_draws(shape, u=None, generator=None, device=None) -> torch.Tensor:
    """`u` when given (checked against `shape`), else U[0, 1) draws of
    `shape` from `generator` on `device`."""
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32, device=device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"injected draws have shape {tuple(u.shape)}, "
                             f"expected {tuple(shape)}")
        return u
    return torch.rand(shape, generator=generator, device=device)


class TwoViewResult(NamedTuple):
    q_rel: torch.Tensor        # [P, 4] relative rotation (x_2 = R_12 x_1 + t_12)
    t_rel: torch.Tensor        # [P, 3] unit relative translation
    inliers: torch.Tensor      # [P, M] bool
    num_inliers: torch.Tensor  # [P] int32
    tri_angle: torch.Tensor    # [P] median triangulation angle of inliers (rad)


# configuration codes of the reference's ConfigurationType
CONFIG_DEGENERATE = 1
CONFIG_CALIBRATED = 2
CONFIG_PLANAR = 4
CONFIG_PANORAMIC = 5
CONFIG_WATERMARK = 7


class TwoViewClassification(NamedTuple):
    config: torch.Tensor        # [P] int32 CONFIG_* code
    H: torch.Tensor             # [P, 3, 3] homography (normalized coords)
    h_inliers: torch.Tensor     # [P, M] bool
    num_h_inliers: torch.Tensor # [P] int32
    q_h: torch.Tensor           # [P, 4] rotation recovered from H
    t_h: torch.Tensor           # [P, 3] unit translation from H (0 when panoramic)
    plane_n: torch.Tensor       # [P, 3] plane normal in camera 1


def _median_masked_rows(x, mask):
    """Row-wise upper median of masked entries (0 for an empty row). x, mask: [P, M]."""
    sorted_x = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1)[0]
    count = mask.sum(-1)
    mid = torch.clamp(count // 2, 0, x.shape[-1] - 1)
    val = torch.gather(sorted_x, 1, mid[:, None])[:, 0]
    return torch.where(count > 0, val, torch.zeros_like(val))


def estimate_relative_poses(x1, x2, mask, thres_sq, num_hypotheses: int = 64,
                            u=None, generator=None) -> TwoViewResult:
    """Relative pose of every pair in one batched pass: S random 8-tuples per
    pair -> 8-point -> closest essential -> Sampson inlier count; one masked
    refit on the winner's inliers; cheirality vote for (R, t).

    x1, x2: [P, M, 2] normalized camera coords; mask [P, M] bool; thres_sq [P]
    squared Sampson threshold. u: injected draws [P, S, 8] (`pair_draws`),
    else drawn from `generator`.
    """
    P, M, _ = x1.shape
    S = num_hypotheses
    dev = x1.device
    u = uniform_draws((P, S, 8), u, generator, dev)
    idx = sample_indices(u, mask)                                    # [P, S, 8]
    rows = torch.arange(P, device=dev)[:, None, None]
    E0 = epipolar.eight_point(
        x1[rows, idx].reshape(P * S, 8, 2), x2[rows, idx].reshape(P * S, 8, 2),
        mask[rows, idx].to(x1.dtype).reshape(P * S, 8))
    E0 = epipolar.essential_closest(E0).reshape(P, S, 3, 3)
    err = epipolar.sampson_error(E0, x1[:, None], x2[:, None])      # [P, S, M]
    inl = (err < thres_sq[:, None, None]) & mask[:, None]
    best = torch.argmax(inl.sum(-1), dim=-1)
    ar = torch.arange(P, device=dev)
    best_inl = inl[ar, best]
    E_best = E0[ar, best]

    # local optimization: one masked LS refit on the winning consensus set
    E_refit = epipolar.essential_closest(
        epipolar.eight_point(x1, x2, best_inl.to(x1.dtype)))
    inl_refit = (epipolar.sampson_error(E_refit, x1, x2) < thres_sq[:, None]) & mask
    better = inl_refit.sum(-1) >= best_inl.sum(-1)
    E_final = torch.where(better[:, None, None], E_refit, E_best)
    inl_final = torch.where(better[:, None], inl_refit, best_inl)

    q, t, _ = epipolar.pose_from_essential(E_final, x1, x2, inl_final.to(x1.dtype))

    # triangulation angle statistic (median over inliers)
    R = rot.quat_to_rotmat(q)
    d1, d2 = epipolar.triangulate_midpoint_depths(R, t, x1, x2)
    X = d1[..., None] * torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]             # cam2 center in cam1
    r1 = -X
    r2 = c2[:, None, :] - X
    cosang = (r1 * r2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-12)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    med_ang = _median_masked_rows(ang, inl_final & (d1 > 0) & (d2 > 0))
    return TwoViewResult(q, t, inl_final, inl_final.sum(-1).to(torch.int32), med_ang)


def classify_two_view(x1, x2, mask, thres_sq, e_inliers, uv1, uv2, image_hw,
                      min_num_inliers: int = 15, max_H_inlier_ratio: float = 0.8,
                      watermark_min_inlier_ratio: float = 0.7,
                      watermark_border_frac: float = 0.1,
                      panoramic_max_t_mag: float = 2e-2, num_hypotheses: int = 32,
                      u=None, generator=None) -> TwoViewClassification:
    """Classify each pair CALIBRATED / PLANAR / PANORAMIC / WATERMARK / DEGENERATE
    (the reference's cascade: H explains > max_H_inlier_ratio of E's support
    and fits tightly -> planar-or-panoramic, split by the Faugeras baseline
    magnitude; watermark = a dominant pure image translation of border
    points). u: injected H-RANSAC draws [P, num_hypotheses, 4].
    """
    from ..geometry.homography import (decompose_homography, homography_ransac,
                                       symmetric_transfer_error)

    num_e = e_inliers.sum(-1)
    H, h_inl, num_h = homography_ransac(x1, x2, mask, thres_sq, num_hypotheses,
                                        u=u, generator=generator)
    R_h, t_h, n_h, t_mag = decompose_homography(H, x1, x2, mask.to(x1.dtype))
    q_h = rot.rotmat_to_quat(R_h)

    h_ratio = num_h.float() / torch.clamp(num_e, min=1).float()
    # small-baseline pairs are H-explainable at the loose threshold even on
    # non-planar scenes; a truly planar/panoramic pair also fits at thres/16
    err_h = symmetric_transfer_error(H, x1, x2)
    num_h_tight = ((err_h < thres_sq[:, None] / 16.0) & mask).sum(-1)
    tight = num_h_tight.float() > 0.5 * torch.clamp(num_h, min=1).float()
    planar_or_pano = (h_ratio > max_H_inlier_ratio) & (num_h >= min_num_inliers) & tight
    panoramic = planar_or_pano & (t_mag < panoramic_max_t_mag)

    d = uv2 - uv1
    w = e_inliers.to(x1.dtype)
    t_med = (d * w[..., None]).sum(1) / torch.clamp(w.sum(1, keepdim=True), min=1.0)
    shift_ok = ((d - t_med[:, None]) ** 2).sum(-1) < 4.0
    Himg, Wimg = image_hw
    border = watermark_border_frac * (Himg ** 2 + Wimg ** 2) ** 0.5

    def in_border(uv):
        return ((uv[..., 0] < border) | (uv[..., 0] > Wimg - border)
                | (uv[..., 1] < border) | (uv[..., 1] > Himg - border))

    wm_pts = shift_ok & in_border(uv1) & in_border(uv2) & e_inliers
    wm_ratio = wm_pts.sum(-1).float() / torch.clamp(num_e, min=1).float()
    watermark = wm_ratio > watermark_min_inlier_ratio

    degenerate = torch.maximum(num_e, num_h.to(num_e.dtype)) < min_num_inliers
    config = torch.full(num_e.shape, CONFIG_CALIBRATED, dtype=torch.int32, device=x1.device)
    for sel, code in ((planar_or_pano, CONFIG_PLANAR), (panoramic, CONFIG_PANORAMIC),
                      (watermark, CONFIG_WATERMARK), (degenerate, CONFIG_DEGENERATE)):
        config = torch.where(sel, torch.full_like(config, code), config)
    t_h = torch.where((config == CONFIG_PANORAMIC)[:, None], torch.zeros_like(t_h), t_h)
    return TwoViewClassification(config, H, h_inl, num_h, q_h, t_h, n_h)
