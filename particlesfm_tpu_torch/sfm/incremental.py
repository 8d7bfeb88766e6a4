"""Incremental SfM mapper, the reference's `incremental_colmap` mode
(port of particlesfm_tpu/sfm/incremental.py).

    seed pair (max inliers x triangulation angle) -> next-best view by 2D-3D
    correspondence count -> PnP RANSAC registration -> retriangulation ->
    growth-triggered global BA + filtering (COLMAP's ba_global_images_ratio
    schedule) -> final refinement.

The host loop is the reference's numpy loop, call for call: the same
candidate order (numpy's argsort of the counts), the same BA track cap
(numpy's argpartition of the scores), so the registration order is the
reference's. Every random draw replays the reference's `jax.random` key:
`PRNGKey(cfg.seed)` split over the pairs for the relative poses, and
`PRNGKey(cfg.seed + img)` for each PnP. The solves run on `device`.

The reference pads the track axis to a multiple of 32768 and the BA camera
count to a multiple of 16 for its compiler; both paddings only add masked
tracks and frozen cameras, whose contributions are exact zeros, so the port
solves the unpadded problem.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..geometry import cameras
from ..globalsfm.ba import bundle_adjust, default_free_masks
from ..globalsfm.pnp import estimate_pose_pnp
from ..globalsfm.tracks3d import TrackObs, filter_observations, triangulate_tracks
from ..globalsfm.twoview import estimate_relative_poses, pair_draws, threefry_key, threefry_uniform
from ..tracks.store import TrackArrays
from ..utils.config import SfmConfig
from .correspondences import (build_observations, build_pair_tensors,
                              geometric_dynamic_track_filter, static_observation_mask,
                              track_inlier_stats)
from .mapper import Reconstruction, _failed, _np

_PNP_CAP = 2048


def run_incremental_mapper(
    tracks: TrackArrays,
    height: int,
    width: int,
    cfg: Optional[SfmConfig] = None,
    params: Optional[np.ndarray] = None,
    log=print,
    device="cuda",
) -> Reconstruction:
    """One incremental reconstruction of `tracks` on `device` (CUDA unless
    the caller asks for the CPU)."""
    cfg = cfg or SfmConfig()
    dev = resolve_device(device)
    if params is None:
        params = cameras.make_default_params(height, width).numpy()
    params = np.asarray(params, np.float32)
    num_images = tracks.num_frames

    def T(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    # seg-geometry gate (as in the global mapper): labels are advisory;
    # exclusions wait for epipolar evidence from the verified pairs below
    seg_dyn_obs = None
    if cfg.remove_dynamic and cfg.seg_geometry_gate and tracks.labels is not None:
        seg_dyn_obs = (tracks.labels != 0) & tracks.mask
        if not seg_dyn_obs.any():
            seg_dyn_obs = None
    if seg_dyn_obs is not None:
        static_mask = tracks.mask.copy()
    else:
        static_mask = static_observation_mask(tracks, cfg.remove_dynamic)
    pair_t = build_pair_tensors(tracks, static_mask, cfg.min_num_matches, seed=cfg.seed)
    P = len(pair_t.pairs)
    if P < 1:
        return _failed(num_images, params, height, width)

    # BA refines the shared focal: normalization always uses the CURRENT
    # focal, or PnP residuals drift against the refined geometry
    def norm(uv, f=None):
        f = f if f is not None else float(params[0])
        return (uv - params[..., 2:4]) / f

    focal0 = float(params[0])
    thres_sq = np.full(P, (cfg.geometric_verification_max_error_px / focal0) ** 2, np.float32)
    tv = estimate_relative_poses(T(norm(pair_t.uv1)), T(norm(pair_t.uv2)), T(pair_t.mask),
                                 T(thres_sq), u=T(pair_draws(cfg.seed, P, (64, 8))))
    num_inl = _np(tv.num_inliers)
    inliers = _np(tv.inliers)
    verified_pairs = num_inl >= cfg.geometric_verification_min_num_inliers
    if seg_dyn_obs is not None:
        good_v, total_v = track_inlier_stats(tracks.num_tracks, pair_t, verified_pairs, inliers)
        rate = good_v / np.maximum(total_v, 1)
        rescued = (total_v >= cfg.seg_rescue_min_samples) & (rate >= cfg.seg_rescue_inlier_rate)
        cand = seg_dyn_obs & ~rescued[:, None]
        log(f"[incremental] seg-geometry gate: "
            f"{int(seg_dyn_obs.any(axis=1).sum())} seg-flagged tracks, "
            f"{int((seg_dyn_obs.any(axis=1) & rescued).sum())} rescued")
        if cand.sum() / max(tracks.mask.sum(), 1) <= 0.6:
            static_mask = static_mask & ~cand
    if cfg.geometric_dynamic_filter:
        dyn = geometric_dynamic_track_filter(
            tracks.num_tracks, pair_t, verified_pairs, inliers,
            cfg.geometric_dynamic_max_inlier_rate, cfg.geometric_dynamic_min_samples)
        if dyn.any():
            log(f"[incremental] geometric dynamic filter flagged {int(dyn.sum())} tracks")
            static_mask = static_mask & ~dyn[:, None]
    ang = _np(tv.tri_angle)
    score = num_inl * np.minimum(np.degrees(ang), 10.0)
    score[num_inl < cfg.geometric_verification_min_num_inliers] = -1
    if score.max() <= 0:
        return _failed(num_images, params, height, width)
    seed_e = int(np.argmax(score))
    i0, j0 = map(int, pair_t.pairs[seed_e])
    log(f"[incremental] seed pair ({i0}, {j0}): {num_inl[seed_e]} inliers, "
        f"{np.degrees(ang[seed_e]):.1f} deg")

    # observation tensors over all images
    obs_t = build_observations(tracks, static_mask, min_track_len=2)
    N = len(obs_t.track_row)
    if N < 8:
        return _failed(num_images, params, height, width)
    obs = TrackObs(T(obs_t.frame_idx, torch.int64), T(obs_t.uv), T(obs_t.mask))
    jparams = T(params)

    registered = np.zeros(num_images, bool)
    unregistrable = np.zeros(num_images, bool)
    q_all = np.tile(np.array([1, 0, 0, 0], np.float32), (num_images, 1))
    t_all = np.zeros((num_images, 3), np.float32)
    registered[i0] = registered[j0] = True
    q_all[j0] = _np(tv.q_rel[seed_e])
    t_all[j0] = _np(tv.t_rel[seed_e])

    def retriangulate():
        """Triangulate with the current poses; only registered observations
        count. Returns (X on the device, good/valid/errs on the host)."""
        gated = TrackObs(obs.frame_idx, obs.uv, obs.mask & T(registered)[obs.frame_idx])
        q, t = T(q_all), T(t_all)
        X = triangulate_tracks(q, t, jparams, gated)
        good, valid, errs = filter_observations(
            q, t, jparams, X, gated,
            cfg.ba.filter_max_reproj_error_px, cfg.ba.filter_min_tri_angle_deg)
        return X, _np(good), _np(valid), _np(errs)

    X, good, valid, _ = retriangulate()
    log(f"[incremental] seed triangulation: {int(valid.sum())} points")

    def global_ba(refine_focal):
        nonlocal jparams
        sub = np.nonzero(registered)[0]
        full2sub = np.zeros(num_images, np.int64)
        full2sub[sub] = np.arange(len(sub))
        sub_frame = full2sub[obs_t.frame_idx]
        gmask = good & registered[obs_t.frame_idx] & valid[:, None]
        free = default_free_masks(max(len(sub), 2), device=dev)[:len(sub)]
        # ranked track cap, as in the global mapper: the solve runs on the
        # best max_tracks tracks, and every retriangulate() re-fits the full
        # set to the refined poses
        cap = cfg.ba.max_tracks
        if N > cap:
            nobs = gmask.sum(axis=1)
            score = valid.astype(np.int64) * 1000 + nobs
            selr = np.sort(np.argpartition(-score, cap)[:cap])
        else:
            selr = np.arange(N)
        dsel = T(selr, torch.int64)
        state = bundle_adjust(
            T(q_all[sub]), T(t_all[sub]), jparams, X[dsel],
            TrackObs(T(sub_frame[selr], torch.int64), obs.uv[dsel], T(gmask[selr])),
            free, T(valid[selr], torch.float32),
            max_iterations=cfg.ba.max_num_iterations // 2,
            use_soft_l1=(cfg.ba.loss == "soft_l1"),
            refine_focal=refine_focal)
        q_all[sub] = _np(state.q)
        t_all[sub] = _np(state.t)
        jparams = state.params

    last_ba_count = 2
    while True:
        # next-best view: most raw observations of currently valid 3D points
        # (`good` covers only registered views, so the full obs mask counts)
        vmask = obs_t.mask & valid[:, None]
        # the reference's np.add.at counts, by the same integers' bincount
        cand_counts = np.bincount(obs_t.frame_idx[vmask], minlength=num_images).astype(np.int64)
        cand_counts[registered | unregistrable] = -1
        order = np.argsort(-cand_counts)
        progressed = False
        X_h = _np(X)
        for img in order:
            if cand_counts[img] < max(cfg.min_num_matches, 6):
                break
            tr, sl = np.nonzero(vmask & (obs_t.frame_idx == img))
            M = min(len(tr), _PNP_CAP)
            Xc = np.zeros((_PNP_CAP, 3), np.float32)
            xc = np.zeros((_PNP_CAP, 2), np.float32)
            mc = np.zeros(_PNP_CAP, bool)
            f_now = float(_np(jparams)[0])
            Xc[:M] = X_h[tr[:M]]
            xc[:M] = norm(obs_t.uv[tr[:M], sl[:M]], f_now)
            mc[:M] = True
            res = estimate_pose_pnp(
                T(Xc), T(xc), T(mc),
                float(np.float32((2 * cfg.geometric_verification_max_error_px / f_now) ** 2)),
                u=T(threefry_uniform(threefry_key(cfg.seed + int(img)), (64, 6))))
            n_inl = int(res.num_inliers)
            if n_inl < max(cfg.min_num_matches, 6):
                log(f"[incremental] image {img}: PnP failed ({n_inl}/{M} inliers), deferring")
                unregistrable[img] = True
                continue
            registered[img] = True
            # a registration changes the map: failed images get another chance
            unregistrable[:] = False
            q_all[img] = _np(res.q)
            t_all[img] = _np(res.t)
            progressed = True
            log(f"[incremental] registered image {img} ({n_inl}/{M} PnP inliers, "
                f"{int(registered.sum())}/{num_images} total)")
            break
        if not progressed:
            break
        X, good, valid, _ = retriangulate()
        if registered.sum() >= 1.25 * last_ba_count:   # COLMAP growth schedule
            global_ba(cfg.ba.refine_focal_length)
            X, good, valid, _ = retriangulate()
            last_ba_count = int(registered.sum())

    if registered.sum() < 3:
        return _failed(num_images, params, height, width)
    for _ in range(2):   # final refinement rounds
        global_ba(cfg.ba.refine_focal_length)
        X, good, valid, errs = retriangulate()
    log(f"[incremental] done: {int(registered.sum())}/{num_images} images, "
        f"{int(valid.sum())} points")

    gated = good & registered[obs_t.frame_idx]
    support = float((gated & valid[:, None]).sum()) / max(int(obs_t.mask.sum()), 1)
    return Reconstruction(
        num_images=num_images, registered=registered, qvec=q_all, tvec=t_all,
        params=_np(jparams), height=height, width=width, points=_np(X),
        track_valid=valid, obs_frame_idx=obs_t.frame_idx, obs_uv=obs_t.uv,
        obs_mask=gated, obs_error=errs, track_row=obs_t.track_row, support=support)
