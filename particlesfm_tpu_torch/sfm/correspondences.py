"""Correspondence preparation: track tensors -> solver-ready batches
(port of particlesfm_tpu/sfm/correspondences.py).

The host part (observation and pair packing, triplet points, vote
statistics, the dynamic-track filters) is the reference's numpy code; the
device part uploads the track tensor once as 1/32 px fixed point, as the
reference does, and computes the dense epipolar votes and the solver's
observation tensor from it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..tracks.store import TrackArrays


@dataclass
class ObsTensors:
    """Per-track padded observations (device layout for triangulation/BA)."""
    frame_idx: np.ndarray    # [N, K] int32
    uv: np.ndarray           # [N, K, 2] float32
    mask: np.ndarray         # [N, K] bool
    track_row: np.ndarray    # [N] int64 — row in the source TrackArrays


@dataclass
class PairTensors:
    """Per-pair padded correspondences (device layout for two-view/translation)."""
    pairs: np.ndarray        # [E, 2] int32 image indices (i < j)
    counts: np.ndarray       # [E] int32 full covisibility counts
    uv1: np.ndarray          # [E, M, 2] float32 pixel coords in image i
    uv2: np.ndarray          # [E, M, 2] float32 pixel coords in image j
    mask: np.ndarray         # [E, M] bool
    track_idx: np.ndarray = None   # [E, M] int64 source track row (-1 padded)


def static_observation_mask(tracks: TrackArrays, remove_dynamic: bool = True,
                            max_dynamic_fraction: float = 0.6) -> np.ndarray:
    """Observation mask with dynamic-labeled points dropped
    (matches_from_flow.py:76-79: labels==1 points are skipped).

    Safety guard beyond the reference: if the labels flag an implausible
    fraction of observations (over-triggering segmentation would starve SfM of
    static structure), the labels are ignored — the mapper's geometric
    epipolar-voting filter still protects against real dynamic objects."""
    mask = tracks.mask.copy()
    if remove_dynamic and tracks.labels is not None:
        dyn = (tracks.labels != 0) & mask
        frac = dyn.sum() / max(mask.sum(), 1)
        if frac <= max_dynamic_fraction:
            mask &= tracks.labels == 0
    return mask


def build_observations(
    tracks: TrackArrays,
    mask: Optional[np.ndarray] = None,
    max_obs_per_track: int = 20,
    min_track_len: int = 2,
) -> ObsTensors:
    """Padded per-track observation tensors, uniformly strided to the cap.

    The cap mirrors the reference's sample_k=20 matches per track
    (matches_from_flow.py:53,87-102): long tracks keep a uniform temporal stride.
    """
    if mask is None:
        mask = static_observation_mask(tracks)
    from .. import native

    fast = native.build_observations(mask, tracks.xy, min_track_len, max_obs_per_track)
    if fast is not None:
        fi, uv, om, rows = fast
        return ObsTensors(frame_idx=fi, uv=uv, mask=om, track_row=rows)
    lengths = mask.sum(axis=1)
    rows = np.nonzero(lengths >= min_track_len)[0]
    N = len(rows)
    K = max_obs_per_track
    frame_idx = np.zeros((N, K), np.int32)
    uv = np.zeros((N, K, 2), np.float32)
    out_mask = np.zeros((N, K), bool)
    for a, n in enumerate(rows):
        t = np.nonzero(mask[n])[0]
        if len(t) > K:
            t = t[np.round(np.linspace(0, len(t) - 1, K)).astype(int)]
        frame_idx[a, : len(t)] = t
        uv[a, : len(t)] = tracks.xy[n, t]
        out_mask[a, : len(t)] = True
    return ObsTensors(frame_idx=frame_idx, uv=uv, mask=out_mask, track_row=rows)


def build_pair_tensors(
    tracks: TrackArrays,
    mask: Optional[np.ndarray] = None,
    min_num_matches: int = 15,
    max_matches_per_pair: int = 256,
    max_span: int = 0,
    seed: int = 100,
) -> PairTensors:
    """Covisibility pairs + padded per-pair correspondence tensors.

    Over-cap pairs keep a RANDOM subset of their common tracks: the positions
    (Floyd's O(M) distinct-sampling, seeded) are chosen here and shared with
    the C++ fast path, so both implementations agree bit-for-bit. Random —
    not strided: track rows are ordered by the tracker's row-major spawn
    grid, and a uniform stride aliases with the grid width, concentrating a
    pair's samples on a few image columns (measured: degraded two-view
    geometry at protocol scale, reconstruction support 0.98 -> 0.49)."""
    if mask is None:
        mask = static_observation_mask(tracks)
    from .. import native

    covis = native.covisibility(mask)
    if covis is None:
        m = mask.astype(np.int32)
        covis = m.T @ m
    iu = np.triu_indices(covis.shape[0], k=1)
    counts = covis[iu]
    keep = counts >= min_num_matches
    # temporal span cap (reference parity: traj_to_matches samples tracks
    # inside sliding windows — trajectory_base.cpp sample_inside_window — so
    # the reference's match graph is effectively banded; our dense tracker
    # keeps >=15 common tracks across 40+ frame baselines, and those pairs'
    # two-view geometry is junk that biases rotation averaging)
    if max_span > 0:
        keep &= (iu[1] - iu[0]) <= max_span
    pairs = np.stack([iu[0][keep], iu[1][keep]], axis=1).astype(np.int32)
    counts = counts[keep].astype(np.int32)

    E, M = len(pairs), max_matches_per_pair
    rng = np.random.default_rng(seed)
    sel = np.zeros((E, M), np.int64)
    for k in range(E):
        C = int(counts[k])
        if C > M:
            sel[k] = np.sort(_floyd_sample(rng, C, M))

    fast = native.build_pair_tensors(mask, tracks.xy, pairs, counts, M, sel)
    if fast is not None:
        uv1, uv2, pmask, tidx = fast
        return PairTensors(pairs=pairs, counts=counts, uv1=uv1, uv2=uv2,
                           mask=pmask, track_idx=tidx)
    uv1 = np.zeros((E, M, 2), np.float32)
    uv2 = np.zeros((E, M, 2), np.float32)
    pmask = np.zeros((E, M), bool)
    tidx = np.full((E, M), -1, np.int64)
    for k, (i, j) in enumerate(pairs):
        common = np.nonzero(mask[:, i] & mask[:, j])[0]
        if len(common) > M:
            common = common[sel[k]]
        uv1[k, : len(common)] = tracks.xy[common, i]
        uv2[k, : len(common)] = tracks.xy[common, j]
        pmask[k, : len(common)] = True
        tidx[k, : len(common)] = common
    return PairTensors(pairs=pairs, counts=counts, uv1=uv1, uv2=uv2, mask=pmask,
                       track_idx=tidx)


def _floyd_sample(rng, n: int, m: int) -> np.ndarray:
    """Floyd's algorithm: m distinct integers from [0, n) in O(m)."""
    chosen = set()
    out = np.empty(m, np.int64)
    w = 0
    for j in range(n - m, n):
        t = int(rng.integers(0, j + 1))
        if t in chosen:
            t = j
        chosen.add(t)
        out[w] = t
        w += 1
    return out


def gather_triplet_points(
    tracks: TrackArrays,
    mask: np.ndarray,
    triplets: np.ndarray,       # [T, 3] image indices (i < j < k)
    max_points: int = 100,
    seed: int = 100,
):
    """Per-triplet common-track observations for baseline-ratio estimation.

    Returns (uv_i, uv_j, uv_k each [T, Q, 2] float32, mask [T, Q] bool).
    max_points mirrors theia's LUD option max_num_points used for the constraint
    weight (least_unsquared_deviation_position_estimator.cc:255).
    """
    rng = np.random.default_rng(seed)
    T, Q = len(triplets), max_points
    uv_i = np.zeros((T, Q, 2), np.float32)
    uv_j = np.zeros((T, Q, 2), np.float32)
    uv_k = np.zeros((T, Q, 2), np.float32)
    out = np.zeros((T, Q), bool)
    for a, (i, j, k) in enumerate(triplets):
        common = np.nonzero(mask[:, i] & mask[:, j] & mask[:, k])[0]
        if len(common) > Q:
            common = rng.choice(common, Q, replace=False)
        uv_i[a, : len(common)] = tracks.xy[common, i]
        uv_j[a, : len(common)] = tracks.xy[common, j]
        uv_k[a, : len(common)] = tracks.xy[common, k]
        out[a, : len(common)] = True
    return uv_i, uv_j, uv_k, out


def track_inlier_stats(
    num_tracks: int,
    pair_t: PairTensors,
    verified: np.ndarray,        # [E] bool — pairs that passed verification
    inliers: np.ndarray,         # [E, M] bool — two-view RANSAC inlier masks
) -> tuple:
    """Per-track epipolar-consistency vote counts over verified pairs.

    Returns (good, total) int64 [num_tracks]: how many pair-correspondences of
    each track were RANSAC inliers vs how many were sampled at all."""
    ti = pair_t.track_idx[verified]
    pm = pair_t.mask[verified] & (ti >= 0)
    inl = np.asarray(inliers)[verified] & pm
    total = np.zeros(num_tracks, np.int64)
    good = np.zeros(num_tracks, np.int64)
    np.add.at(total, ti[pm], 1)
    np.add.at(good, ti[inl], 1)
    return good, total


U16_SCALE = 32.0   # fixed-point pixel coords: 1/32 px step, 2048 px range


def upload_tracks_u16(xy: np.ndarray, mask: np.ndarray, device):
    """The full track tensor on `device`, quantized to the reference's u16
    fixed point (1/32 px, clipped to [0, 65535] steps): (xy [N, T, 2]
    float32 holding the quantized values exactly, mask [N, T] bool).
    Both the dense epipolar votes and the solver's observations read it,
    so they see the coordinates the reference's device sees."""
    q = np.clip(np.round(xy * np.float32(U16_SCALE)), 0, 65535).astype(np.float32)
    xyq = torch.from_numpy(q * np.float32(1.0 / U16_SCALE)).to(device)
    return xyq, torch.from_numpy(np.ascontiguousarray(mask)).to(device)


def full_epipolar_votes(
    pairs: np.ndarray,       # [E, 2] image-index pairs (verified subset)
    E_mats: np.ndarray,      # [E, 3, 3] essential matrices (normalized coords)
    focal: float,
    pp: np.ndarray,          # [2] principal point
    thres_sq: np.ndarray,    # [E] squared Sampson threshold (normalized)
    dev,                     # (xy, mask) from upload_tracks_u16
    chunk: int = 192,
):
    """Per-track epipolar inlier votes over ALL verified pairs, on the device
    of `dev`: every observation pair of every track in every verified
    covisible pair (a length-L track gets ~L(L-1)/2 votes), one dense
    [C, N] Sampson pass per C pairs. Returns (good, total) int64 [N]."""
    from ..geometry import epipolar

    xyq, jmask = dev
    d = xyq.device
    pp_t = torch.as_tensor(np.asarray(pp, np.float32), device=d)
    xyn = (xyq - pp_t) / torch.tensor(float(focal), dtype=torch.float32, device=d)
    N = xyq.shape[0]
    good = torch.zeros(N, dtype=torch.int64, device=d)
    total = torch.zeros(N, dtype=torch.int64, device=d)
    for s in range(0, len(pairs), chunk):
        pij = torch.as_tensor(np.asarray(pairs[s:s + chunk], np.int64), device=d)
        E = torch.as_tensor(np.asarray(E_mats[s:s + chunk], np.float32), device=d)
        th = torch.as_tensor(np.asarray(thres_sq[s:s + chunk], np.float32), device=d)
        i, j = pij[:, 0], pij[:, 1]
        err = epipolar.sampson_error(E, xyn[:, i].transpose(0, 1),
                                     xyn[:, j].transpose(0, 1))      # [C, N]
        valid = (jmask[:, i] & jmask[:, j]).T
        good += ((err < th[:, None]) & valid).sum(0)
        total += valid.sum(0)
    return good.cpu().numpy(), total.cpu().numpy()


def build_obs_device(dev, rows, orig_fi, sub_fi, omask):
    """The solver's observation tensor from the uploaded track tensor: rows
    [N] track row per observation row, orig_fi [N, K] ORIGINAL frame index
    per slot (the track tensor's time axis), sub_fi [N, K] registered-subset
    frame index (what the solvers see), omask [N, K] bool."""
    from ..globalsfm.tracks3d import TrackObs

    xyq = dev[0]
    d = xyq.device
    rows = torch.as_tensor(np.asarray(rows, np.int64), device=d)
    ofi = torch.as_tensor(np.asarray(orig_fi, np.int64), device=d)
    m = torch.as_tensor(np.asarray(omask, bool), device=d)
    uv = xyq[rows[:, None], ofi] * m[..., None]
    return TrackObs(torch.as_tensor(np.asarray(sub_fi, np.int64), device=d), uv, m)


def geometric_dynamic_track_filter(
    num_tracks: int,
    pair_t: PairTensors,
    verified: np.ndarray,        # [E] bool — pairs that passed verification
    inliers: np.ndarray,         # [E, M] bool — two-view RANSAC inlier masks
    max_inlier_rate: float = 0.3,
    min_samples: int = 4,
) -> np.ndarray:
    """Learning-free dynamic-track detection by epipolar-consistency voting.

    A static-scene track is an epipolar inlier in (nearly) every verified pair
    it participates in; a track on an independently-moving object is rejected by
    most pairwise RANSACs. Tracks with enough samples and a low inlier rate are
    flagged dynamic. Returns [num_tracks] bool. This is a fallback complement to
    the learned motion segmentation (the reference has no geometric filter — it
    relies entirely on its trained network).
    """
    good, total = track_inlier_stats(num_tracks, pair_t, verified, inliers)
    rate = good / np.maximum(total, 1)
    return (total >= min_samples) & (rate < max_inlier_rate)


def two_model_motion_clustering(
    num_tracks: int,
    pair_t: PairTensors,
    verified: np.ndarray,        # [E] bool
    member_a: np.ndarray,        # [E, M] bool — under-threshold vs model A
    member_b: np.ndarray,        # [E, M] bool — under-threshold vs model B
    has_b: np.ndarray,           # [E] bool — second model exists & verified
    min_votes: int = 3,
    max_dynamic_fraction: float = 0.5,
    rounds: int = 3,
) -> np.ndarray:
    """Cross-pair motion clustering over sequential two-model RANSAC outputs.

    The slow-large-object failure (DESIGN.md hard case): on short baselines one
    essential matrix blends both motion populations, so per-pair inlier voting
    cannot separate them — but on wide-baseline pairs the accumulated object
    displacement exceeds the threshold and the populations split into models A
    and B. Ambiguous observations (inliers of BOTH models — the short-baseline
    blend) cast no vote; unambiguous ones vote for their model. Which local
    model is "static" is resolved per pair by overlap with the current static
    set, seeded by spatial coverage (the background spans the frame; an object
    is compact) — this is the label-alignment step that turns per-pair
    memberships into a global clustering. Tracks whose votes are mostly on the
    non-static side are dynamic. A fraction guard ignores implausible results
    (if "dynamic" won most of the scene, the clustering is untrustworthy).

    Returns [num_tracks] bool. Reference has no counterpart (relies on its
    trained net); this is the geometry-only defense (NEXT round-2 item #2).
    """
    ve = np.asarray(verified)
    ti = pair_t.track_idx[ve]
    pm = pair_t.mask[ve] & (ti >= 0)
    mA = np.asarray(member_a)[ve] & pm
    mB = np.asarray(member_b)[ve] & pm & np.asarray(has_b)[ve, None]
    onlyA = mA & ~mB
    onlyB = mB & ~mA
    uv = pair_t.uv1[ve]

    # spatial-coverage seed: per pair, the side whose unambiguous members
    # spread wider in the image is provisionally static
    def spread(m):
        cnt = np.maximum(m.sum(axis=1), 1)
        mean = (uv * m[..., None]).sum(axis=1) / cnt[:, None]
        var = (((uv - mean[:, None]) ** 2) * m[..., None]).sum(axis=1) / cnt[:, None]
        return np.sqrt(var.sum(axis=1))

    a_static = spread(onlyA) >= spread(onlyB)

    dynamic = np.zeros(num_tracks, bool)
    for _ in range(rounds):
        stat_votes = np.zeros(num_tracks, np.int64)
        dyn_votes = np.zeros(num_tracks, np.int64)
        sA = np.where(a_static[:, None], onlyA, onlyB)
        sB = np.where(a_static[:, None], onlyB, onlyA)
        np.add.at(stat_votes, ti[sA], 1)
        np.add.at(dyn_votes, ti[sB], 1)
        total = stat_votes + dyn_votes
        new_dyn = (total >= min_votes) & (dyn_votes > stat_votes)
        # realign per-pair static side against the updated static set
        trk_static = ~new_dyn
        ovA = (onlyA & trk_static[np.clip(ti, 0, None)]).sum(axis=1)
        ovB = (onlyB & trk_static[np.clip(ti, 0, None)]).sum(axis=1)
        a_static = np.where(ovA == ovB, a_static, ovA > ovB)
        if (new_dyn == dynamic).all():
            dynamic = new_dyn
            break
        dynamic = new_dyn

    participating = np.zeros(num_tracks, bool)
    participating[ti[pm]] = True
    denom = max(int(participating.sum()), 1)
    if dynamic.sum() > max_dynamic_fraction * denom:
        return np.zeros(num_tracks, bool)
    return dynamic
