"""Global SfM mapper: the reconstruction state machine over the device solvers
(port of particlesfm_tpu/sfm/mapper.py).

    rotations -> pairwise translation refinement -> positions -> register
    -> triangulate -> iterative refinement (translation-only BA phase, then joint)

with the reference's filter cascade (two-view inlier gates, dynamic-track
filters, degenerate-pair classification, orientation filter + largest
connected component, MFAS), its multi-start controller and retry cascade,
and the same refinement schedule.

Host code sequences the stages and reshapes arrays; the solves run on
`device`. Every random draw replays the reference's `jax.random` key for
the same `cfg.seed` (globalsfm/twoview.py threefry), so both packages test
the same RANSAC hypotheses on the same tracks.

Traced (`utils.profiling`), each mapper start is the spans `sfm.pairs`,
`sfm.twoview`, `sfm.rotations`, `sfm.positions` and `sfm.ba` in turn, each
timed on `device` (scoring finished models between starts belongs to
`sfm.ba`), and the counter `sfm.mapper_runs` counts the starts, retries
included.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..geometry import cameras, epipolar, rotations as rot, se3
from ..globalsfm.ba import bundle_adjust, default_free_masks
from ..globalsfm.linear_position import estimate_positions_linear
from ..globalsfm.nonlinear_position import refine_positions_nonlinear
from ..globalsfm.pnp import estimate_pose_pnp
from ..globalsfm.rotation_averaging import average_rotations
from ..globalsfm.tracks3d import TrackObs, filter_observations, triangulate_tracks
from ..globalsfm.translation import (directions_from_relative_poses, estimate_positions_lud,
                                     refine_pairwise_translations)
from ..globalsfm.triplets import triplet_baseline_constraints
from ..globalsfm.twoview import (CONFIG_PANORAMIC, CONFIG_PLANAR, CONFIG_WATERMARK,
                                 classify_two_view, estimate_relative_poses, pair_draws,
                                 threefry_key, threefry_uniform)
from ..graph import (extract_triplets, filter_pairs_by_orientation, largest_connected_component,
                     loop_consistency_filter, mfas_position_filter,
                     orientations_from_spanning_tree)
from ..tracks.store import TrackArrays
from ..utils import profiling
from ..utils.config import SfmConfig
from .correspondences import (build_obs_device, build_observations, build_pair_tensors,
                              full_epipolar_votes, gather_triplet_points,
                              static_observation_mask, two_model_motion_clustering,
                              upload_tracks_u16)

_BUCKET = 32768   # the reference's track-axis bucket (it ranks BA's tracks over it)


@dataclass
class Reconstruction:
    """Result container (host arrays, full image indexing)."""
    num_images: int
    registered: np.ndarray          # [T] bool
    qvec: np.ndarray                # [T, 4] world->cam
    tvec: np.ndarray                # [T, 3]
    params: np.ndarray              # [5] shared canonical intrinsics
    height: int = 0
    width: int = 0
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    track_valid: np.ndarray = field(default_factory=lambda: np.zeros((0,), bool))
    obs_frame_idx: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int32))
    obs_uv: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 2), np.float32))
    obs_mask: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), bool))
    obs_error: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    track_row: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))
    support: float = 0.0   # kept-observation fraction of the solver's obs set

    @property
    def num_registered(self) -> int:
        return int(self.registered.sum())


def _failed(num_images: int, params: np.ndarray, height: int, width: int) -> Reconstruction:
    return Reconstruction(
        num_images=num_images,
        registered=np.zeros(num_images, bool),
        qvec=np.tile(np.array([1.0, 0, 0, 0], np.float32), (num_images, 1)),
        tvec=np.zeros((num_images, 3), np.float32),
        params=params, height=height, width=width)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _median(x: torch.Tensor) -> float:
    """jnp.median of a 1-D tensor: the mean of the two middle values."""
    n = x.numel()
    if n == 0:
        return float("nan")
    s = torch.sort(x)[0]
    return float(0.5 * s[(n - 1) // 2] + 0.5 * s[n // 2])


def _nanmedian(x: torch.Tensor) -> float:
    return _median(x[~torch.isnan(x)])


def run_global_mapper(
    tracks: TrackArrays,
    height: int,
    width: int,
    cfg: Optional[SfmConfig] = None,
    params: Optional[np.ndarray] = None,
    log=print,
    focal_bound_frac: Optional[float] = None,
    device="cuda",
) -> Reconstruction:
    """Global mapper: multi-start over view-graph gating + retry cascade.

    In the true basin the kept observations sit at flow-noise level
    (~0.25 px); warped basins plateau at 0.8-1.3 px. Start with the ungated
    view graph; if the kept-obs error exceeds cfg.multi_start_err_px, rerun
    with the triplet loop-consistency gate and keep the candidate with the
    better kept-obs / err^2 x coverage score. Runs on `device` (CUDA unless
    the caller asks for the CPU).
    """
    cfg = cfg or SfmConfig()
    dev = resolve_device(device)
    rec = _mapper_with_retries(tracks, height, width, cfg, params, log, focal_bound_frac, dev)
    # traced, scoring a finished model is part of `sfm.ba`
    with profiling.span("sfm.ba", device=dev):
        e1 = _kept_err(rec)
    if (cfg.multi_start_err_px > 0 and cfg.pre_orientation_filter_deg == 0
            and (rec.num_registered < 3 or e1 > cfg.multi_start_err_px)):
        log(f"[mapper] kept-obs mean reprojection {e1:.2f}px > "
            f"{cfg.multi_start_err_px}px (not at flow-noise level); "
            "multi-start with loop-consistency gate")
        cfg2 = replace(cfg, pre_orientation_filter_deg=6.0)
        rec2 = _mapper_with_retries(tracks, height, width, cfg2, params, log,
                                    focal_bound_frac, dev)
        with profiling.span("sfm.ba", device=dev):
            s1 = _convergence_score(rec, height, width)
            s2 = _convergence_score(rec2, height, width)
            e2 = _kept_err(rec2)
        log(f"[mapper] multi-start scores (obs/err^2 x coverage): "
            f"ungated {s1:.0f} vs gated {s2:.0f} "
            f"(err {e1:.2f} vs {e2:.2f}px)")
        if s2 > s1:
            rec = rec2
    return rec


def _kept_err(rec: Reconstruction) -> float:
    """Mean reprojection error over kept observations of valid tracks."""
    if not len(rec.track_valid):
        return float("inf")
    sel = rec.obs_mask & rec.track_valid[:, None]
    if not sel.any():
        return float("inf")
    return float(rec.obs_error[sel].mean())


def _convergence_score(rec: Reconstruction, height: int, width: int) -> float:
    """Kept observations / (mean err^2 + 0.05) x coverage."""
    sel = rec.obs_mask & rec.track_valid[:, None]
    if not sel.any() or rec.num_registered < 3:
        return 0.0
    e = _kept_err(rec)
    return float(sel.sum()) / (e * e + 0.05) * _coverage_fraction(rec, height, width)


def _coverage_fraction(rec: Reconstruction, height: int, width: int, grid: int = 16) -> float:
    """Occupied fraction of a coarse image cell grid over kept observations."""
    sel = rec.obs_mask & rec.track_valid[:, None]
    if not sel.any():
        return 0.0
    uv = rec.obs_uv[sel]
    gx = np.clip((uv[:, 0] / max(width, 1) * grid).astype(int), 0, grid - 1)
    gy = np.clip((uv[:, 1] / max(height, 1) * grid).astype(int), 0, grid - 1)
    occupied = np.zeros((grid, grid), bool)
    occupied[gy, gx] = True
    return float(occupied.mean())


def _model_score(rec: Reconstruction, height: int, width: int, grid: int = 16) -> float:
    """Kept observations weighted by image coverage."""
    sel = rec.obs_mask & rec.track_valid[:, None]
    if not sel.any():
        return 0.0
    return float(sel.sum()) * _coverage_fraction(rec, height, width, grid)


def _mapper_with_retries(tracks, height, width, cfg, params, log, focal_bound_frac, dev):
    """One mapper start + the staged retry cascade: glomap positioning when
    fewer than half the tracks are valid, then the complement model when
    support is low and coverage compact."""
    fe_cache: dict = {}
    rec = _run_global_mapper_once(tracks, height, width, cfg, params, log, dev,
                                  fe_out=fe_cache, focal_bound_frac=focal_bound_frac)
    if cfg.sfm_type != "glomap" and rec.num_registered >= 3:
        vfrac = (float(rec.track_valid.sum()) / max(len(rec.track_valid), 1)
                 if len(rec.track_valid) else 0.0)
        if vfrac < 0.5:
            log(f"[mapper] valid-track fraction {vfrac:.2f} after full-set "
                "retriangulation; retrying with glomap positioning")
            cfg_g = replace(cfg, sfm_type="glomap")
            if fe_cache:
                # the front end is identical for both positioning paths
                profiling.count("sfm.mapper_runs")
                rec_g = _position_and_refine(tracks, height, width, cfg_g, fe_cache, log, dev)
            else:
                rec_g = _run_global_mapper_once(tracks, height, width, cfg_g, params, log, dev,
                                                focal_bound_frac=focal_bound_frac)
            with profiling.span("sfm.ba", device=dev):
                s1 = _model_score(rec, height, width)
                s2 = _model_score(rec_g, height, width)
            log(f"[mapper] glomap-retry scores: lud {s1:.0f} vs glomap {s2:.0f}")
            if s2 > s1:
                rec = rec_g

    # a dominant-object lock explains observations only inside the object's
    # compact image region; a broad-coverage model is the background
    with profiling.span("sfm.ba", device=dev):
        cov = _coverage_fraction(rec, height, width)
    if rec.support < 0.5 and cov < 0.55 and rec.num_registered >= 3:
        log(f"[mapper] low support ({rec.support:.2f}) with compact coverage "
            f"({cov:.2f}); trying the complement model")
        comp_mask = tracks.mask.copy()
        comp_mask[np.unique(rec.track_row[rec.track_valid])] = False
        comp = TrackArrays(xy=tracks.xy, mask=comp_mask, labels=tracks.labels)
        rec2 = _run_global_mapper_once(comp, height, width, cfg, params, log, dev,
                                       focal_bound_frac=focal_bound_frac)
        with profiling.span("sfm.ba", device=dev):
            s1 = _model_score(rec, height, width)
            s2 = _model_score(rec2, height, width)
        log(f"[mapper] model scores (kept-obs x image coverage): "
            f"primary {s1:.0f} vs complement {s2:.0f}")
        if s2 > s1:
            return rec2
    return rec


def _verified(num_inl, pmask, cfg):
    return (num_inl >= cfg.geometric_verification_min_num_inliers) & (
        num_inl >= cfg.geometric_verification_min_inlier_ratio * np.maximum(pmask.sum(axis=1), 1))


def _run_global_mapper_once(tracks, height, width, cfg, params, log, dev,
                            fe_out: Optional[dict] = None, focal_bound_frac=None):
    """One mapper start: the front end (pairs, two-view geometry, rotations)
    and `_position_and_refine`. Traced, the front end is the spans
    `sfm.pairs`, `sfm.twoview` and `sfm.rotations`, back to back."""
    profiling.count("sfm.mapper_runs")
    with profiling.steps(device=dev) as step:
        fe = _front_end(tracks, height, width, cfg, params, log, dev, step, focal_bound_frac)
    if isinstance(fe, Reconstruction):
        return fe
    if fe_out is not None:
        fe_out.update(fe)
    return _position_and_refine(tracks, height, width, cfg, fe, log, dev)


def _front_end(tracks, height, width, cfg, params, log, dev, step, focal_bound_frac):
    """The front-end products `_position_and_refine` reads, or a failed
    Reconstruction. `step(name)` starts each of its spans."""
    step("sfm.pairs")
    default_prior = params is None
    if params is None:
        params = cameras.make_default_params(height, width).numpy()
    num_images = tracks.num_frames
    focal = float(params[0])
    # BA's focal trust region applies only when the prior is a measurement
    bf = 0.15 if focal_bound_frac is None else float(focal_bound_frac)
    focal_bounds = (None if default_prior else
                    torch.tensor([(1 - bf) * focal, (1 + bf) * focal], dtype=torch.float32,
                                 device=dev))

    def T(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    # ---- correspondences -------------------------------------------------
    # seg-geometry gate: defer label exclusions until two-view verification
    # supplies per-track epipolar evidence
    seg_dyn_obs = None
    if cfg.remove_dynamic and cfg.seg_geometry_gate and tracks.labels is not None:
        seg_dyn_obs = (tracks.labels != 0) & tracks.mask
        if not seg_dyn_obs.any():
            seg_dyn_obs = None
    if seg_dyn_obs is not None:
        static_mask = tracks.mask.copy()
    else:
        static_mask = static_observation_mask(tracks, cfg.remove_dynamic)
    pair_t = build_pair_tensors(tracks, static_mask, cfg.min_num_matches, seed=cfg.seed,
                                max_span=getattr(cfg, "max_pair_span", 0))
    if len(pair_t.pairs) < 3:
        log("[mapper] too few covisible pairs; reconstruction failed")
        return _failed(num_images, params, height, width)
    log(f"[mapper] {len(pair_t.pairs)} covisible pairs")
    P = len(pair_t.pairs)
    dev_tracks = upload_tracks_u16(tracks.xy, tracks.mask, dev)

    # ---- two-view geometry (batched RANSAC) ------------------------------
    step("sfm.twoview")

    def norm(uv):
        return (uv - params[None, None, 2:4]) / focal

    thres_sq = np.full(P, (cfg.geometric_verification_max_error_px / focal) ** 2, np.float32)
    x1n, x2n = T(norm(pair_t.uv1)), T(norm(pair_t.uv2))
    u_pose = T(pair_draws(cfg.seed, P, (64, 8)))
    pmask = pair_t.mask.copy()
    # two passes: if the dynamic-track filters flag anything, the pairwise
    # poses are re-estimated without those correspondences
    for attempt in range(2):
        tv = estimate_relative_poses(x1n, x2n, T(pmask), T(thres_sq), u=u_pose)
        num_inl = _np(tv.num_inliers)
        verified = _verified(num_inl, pmask, cfg)
        log(f"[mapper] geometric verification kept {verified.sum()}/{len(verified)} pairs")
        if verified.sum() < 3:
            return _failed(num_images, params, height, width)
        if attempt > 0 or not (cfg.geometric_dynamic_filter or cfg.two_model_ransac
                               or seg_dyn_obs is not None):
            break

        # dense per-track epipolar votes against every verified pair's E
        E_ver = _np(epipolar.essential_from_pose(tv.q_rel, tv.t_rel))
        good_v, total_v = full_epipolar_votes(
            pair_t.pairs[verified], E_ver[verified], focal, params[2:4],
            thres_sq[verified], dev=dev_tracks, chunk=192)
        rate = good_v / np.maximum(total_v, 1)

        # seg labels gated on geometric evidence: a seg-flagged track whose
        # observations were epipolar inliers often enough keeps them
        seg_remove = None
        if seg_dyn_obs is not None:
            rescued = (total_v >= cfg.seg_rescue_min_samples) & (
                rate >= cfg.seg_rescue_inlier_rate)
            cand = seg_dyn_obs & ~rescued[:, None]
            nseg = int(seg_dyn_obs.any(axis=1).sum())
            nresc = int((seg_dyn_obs.any(axis=1) & rescued).sum())
            frac = cand.sum() / max(tracks.mask.sum(), 1)
            log(f"[mapper] seg-geometry gate: {nseg} seg-flagged tracks, "
                f"{nresc} rescued by epipolar consistency")
            if frac <= 0.6:
                seg_remove = cand
            else:
                log(f"[mapper] seg labels over-trigger ({frac:.2f} of obs); ignored")

        dyn = np.zeros(tracks.num_tracks, bool)
        if cfg.geometric_dynamic_filter:
            dyn |= ((total_v >= cfg.geometric_dynamic_min_samples)
                    & (rate < cfg.geometric_dynamic_max_inlier_rate))
        if cfg.two_model_ransac:
            # sequential second model on the first model's outliers
            mask_b = pmask & ~_np(tv.inliers)
            tv_b = estimate_relative_poses(x1n, x2n, T(mask_b), T(thres_sq),
                                           u=T(pair_draws(cfg.seed + 7, P, (64, 8))))
            has_b2 = _np(tv_b.num_inliers) >= max(cfg.geometric_verification_min_num_inliers, 8)
            E_b = epipolar.essential_from_pose(tv_b.q_rel, tv_b.t_rel)
            err_b = _np(epipolar.sampson_error(E_b, x1n, x2n))
            member_b = (err_b < thres_sq[:, None]) & pair_t.mask
            dyn2 = two_model_motion_clustering(
                tracks.num_tracks, pair_t, verified, _np(tv.inliers), member_b, has_b2,
                cfg.two_model_min_votes, cfg.two_model_max_dynamic_fraction)
            if dyn2.any():
                log(f"[mapper] two-model clustering flagged {int(dyn2.sum())} tracks")
            dyn |= dyn2
        if not dyn.any() and (seg_remove is None or not seg_remove.any()):
            break
        if dyn.any():
            log(f"[mapper] geometric dynamic filters flagged {int(dyn.sum())} "
                "tracks; re-estimating pairwise geometry without them")
            static_mask = static_mask & ~dyn[:, None]
        ti = pair_t.track_idx
        tic = np.clip(ti, 0, None)
        pmask = pmask & ~(dyn[tic] & (ti >= 0))
        if seg_remove is not None and seg_remove.any():
            static_mask = static_mask & ~seg_remove
            # kill pair correspondences whose endpoint observation was removed
            rm = (seg_remove[tic, pair_t.pairs[:, None, 0]]
                  | seg_remove[tic, pair_t.pairs[:, None, 1]]) & (ti >= 0)
            pmask = pmask & ~rm

    # ---- track-level shared-focal self-calibration when no intrinsics were
    # given (the pipeline passes the flow-level estimate instead)
    if default_prior and cfg.selfcal_focal:
        from ..globalsfm.selfcal import estimate_shared_focal, reference_draws

        scal_mask = pmask & _np(tv.inliers) & verified[:, None]
        f_lo, f_hi = 0.3 * max(height, width), 3.0 * max(height, width)
        u_f, u_h = reference_draws(cfg.seed + 11, P)
        est = estimate_shared_focal(
            T(pair_t.uv1), T(pair_t.uv2), T(scal_mask), T(params[2:4]), f_lo, f_hi,
            thres_px_sq=float(cfg.geometric_verification_max_error_px) ** 2,
            u_f=u_f.to(dev), u_h=u_h.to(dev))
        f_hat = float(est.focal)
        curve = _np(est.curve)
        dip = float(curve.min() / max(float(np.median(curve)), 1e-9))
        grid = _np(est.f_grid)
        interior = grid[1] < f_hat < grid[-2]
        usable = (interior and int(est.num_pairs) >= cfg.selfcal_min_pairs
                  and dip <= cfg.selfcal_max_dip
                  and float(est.confidence) >= cfg.selfcal_min_conf)
        if usable:
            log(f"[mapper] self-calibrated focal {f_hat:.1f} (prior {focal:.1f}, "
                f"conf {float(est.confidence):.2f}, dip {dip:.2f})")
            if abs(np.log(f_hat / focal)) > 0.02:
                # re-estimate pairwise geometry under the calibrated focal
                params = params.copy()
                params[0] = params[1] = focal = f_hat
                x1n, x2n = T(norm(pair_t.uv1)), T(norm(pair_t.uv2))
                thres_sq = np.full(
                    P, (cfg.geometric_verification_max_error_px / focal) ** 2, np.float32)
                tv = estimate_relative_poses(x1n, x2n, T(pmask), T(thres_sq), u=u_pose)
                num_inl = _np(tv.num_inliers)
                verified = _verified(num_inl, pmask, cfg)
                if verified.sum() < 3:
                    return _failed(num_images, params, height, width)
        else:
            log(f"[mapper] focal self-calibration inconclusive "
                f"(conf {float(est.confidence):.2f}, dip {dip:.2f}, "
                f"n {int(est.num_pairs)}, interior {interior}); keeping prior {focal:.1f}")

    # ---- degenerate-configuration classification: planar pairs take their
    # pose from H, panoramic pairs keep only their rotation, watermark pairs go
    q_all = _np(tv.q_rel)
    t_all = _np(tv.t_rel)
    has_baseline = np.ones(P, bool)
    if cfg.classify_degenerate:
        cls = classify_two_view(
            x1n, x2n, T(pmask), T(thres_sq), tv.inliers, T(pair_t.uv1), T(pair_t.uv2),
            (height, width),
            min_num_inliers=cfg.geometric_verification_min_num_inliers,
            max_H_inlier_ratio=cfg.max_H_inlier_ratio,
            watermark_min_inlier_ratio=cfg.watermark_min_inlier_ratio,
            panoramic_max_t_mag=cfg.panoramic_max_t_mag,
            u=T(pair_draws(cfg.seed + 1, P, (32, 4))))
        cfgs = _np(cls.config)
        planar = cfgs == CONFIG_PLANAR
        pano = cfgs == CONFIG_PANORAMIC
        wmark = cfgs == CONFIG_WATERMARK
        if planar.any() or pano.any() or wmark.any():
            log(f"[mapper] two-view configs: {int(planar.sum())} planar, "
                f"{int(pano.sum())} panoramic, {int(wmark.sum())} watermark")
        q_all = np.where((planar | pano)[:, None], _np(cls.q_h), q_all)
        t_all = np.where(planar[:, None], _np(cls.t_h), t_all)
        has_baseline = ~pano
        verified = verified & ~wmark
        if verified.sum() < 3:
            log("[mapper] all pairs degenerate after classification")
            return _failed(num_images, params, height, width)

    pairs = pair_t.pairs[verified]
    counts = num_inl[verified]
    R_rel = _np(rot.quat_to_rotmat(T(q_all)))[verified]
    t_rel = t_all[verified]
    has_b = has_baseline[verified]
    inl_mask = _np(tv.inliers)[verified]
    uv1 = pair_t.uv1[verified]
    uv2 = pair_t.uv2[verified]

    # ---- registered subset = largest connected component -----------------
    in_lcc = largest_connected_component(num_images, pairs)
    sub = np.nonzero(in_lcc)[0]
    full2sub = np.full(num_images, -1, np.int64)
    full2sub[sub] = np.arange(len(sub))
    pkeep = in_lcc[pairs[:, 0]] & in_lcc[pairs[:, 1]]
    pairs, counts, R_rel, t_rel = pairs[pkeep], counts[pkeep], R_rel[pkeep], t_rel[pkeep]
    inl_mask, uv1, uv2, has_b = inl_mask[pkeep], uv1[pkeep], uv2[pkeep], has_b[pkeep]
    spairs = full2sub[pairs].astype(np.int32)
    V = len(sub)
    log(f"[mapper] largest component: {V}/{num_images} images, {len(pairs)} pairs")
    if V < 3:
        return _failed(num_images, params, height, width)

    # ---- pre-averaging loop-consistency gate (multi-start's second start)
    step("sfm.rotations")
    if cfg.pre_orientation_filter_deg > 0:
        keep = loop_consistency_filter(V, spairs, R_rel, max_err_deg=cfg.pre_orientation_filter_deg)
        if (not keep.all() and keep.sum() >= max(3, int(0.3 * len(spairs)))
                and largest_connected_component(V, spairs[keep]).all()):
            log(f"[mapper] loop-consistency gate kept {int(keep.sum())}/{len(keep)} pairs")
            spairs, counts, R_rel, t_rel = spairs[keep], counts[keep], R_rel[keep], t_rel[keep]
            inl_mask, uv1, uv2, has_b = inl_mask[keep], uv1[keep], uv2[keep], has_b[keep]
        elif not keep.all():
            log(f"[mapper] loop-consistency gate would disconnect the graph "
                f"({int(keep.sum())}/{len(keep)} kept); skipped")

    # ---- rotation averaging (the reference pads the edges with weight-0
    # rows for its compiler; they add exact zeros, so the port does not)
    R_init = orientations_from_spanning_tree(V, spairs, counts, R_rel)
    Er = len(spairs)

    def rotations(edges, Rr, R0):
        return average_rotations(
            V, T(edges, torch.int64), T(Rr, torch.float32), R0,
            torch.ones(len(edges), dtype=torch.float32, device=dev),
            l1_iters=cfg.rotation.max_num_l1_iterations,
            irls_iters=cfg.rotation.max_num_irls_iterations,
            sigma_deg=cfg.rotation.irls_loss_parameter_sigma_deg)

    R_abs, rot_info = rotations(spairs, R_rel, T(R_init, torch.float32))
    log(f"[mapper] rotation averaging: {rot_info['l1_iters']} L1 + "
        f"{rot_info['irls_iters']} IRLS iters, mean residual "
        f"{np.degrees(float(rot_info['mean_residual_rad'])):.3f} deg")
    ok = filter_pairs_by_orientation(spairs, R_rel, _np(R_abs), cfg.filter_max_orientation_error_deg)
    log(f"[mapper] orientation filter kept {ok.sum()}/{len(ok)} pairs")
    spairs, counts, R_rel, t_rel = spairs[ok], counts[ok], R_rel[ok], t_rel[ok]
    inl_mask, uv1, uv2, has_b = inl_mask[ok], uv1[ok], uv2[ok], has_b[ok]

    in_lcc2 = largest_connected_component(V, spairs)
    if not in_lcc2.all():
        sub2 = np.nonzero(in_lcc2)[0]
        remap = np.full(V, -1, np.int64)
        remap[sub2] = np.arange(len(sub2))
        pkeep = in_lcc2[spairs[:, 0]] & in_lcc2[spairs[:, 1]]
        spairs = remap[spairs[pkeep]].astype(np.int32)
        counts, R_rel, t_rel = counts[pkeep], R_rel[pkeep], t_rel[pkeep]
        inl_mask, uv1, uv2, has_b = inl_mask[pkeep], uv1[pkeep], uv2[pkeep], has_b[pkeep]
        R_abs = R_abs[T(sub2, torch.int64)]
        sub = sub[sub2]
        full2sub = np.full(num_images, -1, np.int64)
        full2sub[sub] = np.arange(len(sub))
        V = len(sub)
        log(f"[mapper] post-orientation component: {V} images")
        if V < 3:
            return _failed(num_images, params, height, width)

    # ---- re-average rotations on the filtered graph when the orientation
    # filter removed a material fraction of pairs
    if len(spairs) < 0.98 * Er and len(spairs) >= 3:
        R_abs, rot_info2 = rotations(spairs, R_rel, R_abs)
        log(f"[mapper] re-averaged rotations on filtered graph: "
            f"{rot_info2['irls_iters']} IRLS iters, mean residual "
            f"{np.degrees(float(rot_info2['mean_residual_rad'])):.3f} deg")

    # ---- gauge anchors: the best-supported view, and its farthest
    # well-supported covisible partner (a real baseline for the scale gauge)
    deg = np.zeros(V, np.int64)
    np.add.at(deg, spairs[:, 0], counts)
    np.add.at(deg, spairs[:, 1], counts)
    a0 = int(np.argmax(deg))
    touching = spairs[(spairs[:, 0] == a0) | (spairs[:, 1] == a0)]
    partners = np.unique(touching[touching != a0])
    if len(partners):
        strong = partners[deg[partners] >= 0.25 * deg[partners].max()]
        a1 = int(strong[np.argmax(np.abs(strong - a0))])
    else:
        a1 = (a0 + 1) % V
    anchor = (a0, a1)
    log(f"[mapper] gauge anchors: views {a0}, {a1} (support {deg[a0]}, {deg[a1]})")

    # ---- track observations in the registered subset ----------------------
    obs_t = build_observations(tracks, static_mask, min_track_len=2)
    sub_frame = full2sub[obs_t.frame_idx]
    omask = obs_t.mask & (sub_frame >= 0)
    keep_tracks = omask.sum(axis=1) >= 2
    orig_fi = np.where(omask, obs_t.frame_idx, 0).astype(np.int32)[keep_tracks]
    obs_t.frame_idx = np.where(omask, sub_frame, 0).astype(np.int32)[keep_tracks]
    obs_t.uv = obs_t.uv[keep_tracks]
    obs_t.mask = omask[keep_tracks]
    obs_t.track_row = obs_t.track_row[keep_tracks]
    N = len(obs_t.track_row)
    log(f"[mapper] {N} tracks with >= 2 registered observations")
    if N < 8:
        return _failed(num_images, params, height, width)
    # the solver reads the fixed-point track upload, as the reference's does
    obs = build_obs_device(dev_tracks, obs_t.track_row, orig_fi, obs_t.frame_idx, obs_t.mask)

    return dict(params=params, focal=focal, focal_bounds=focal_bounds, obs=obs, obs_t=obs_t,
                N=N, V=V, sub=sub, full2sub=full2sub, anchor=anchor, R_abs=R_abs,
                spairs=spairs, counts=counts, R_rel=R_rel, t_rel=t_rel, inl_mask=inl_mask,
                uv1=uv1, uv2=uv2, has_b=has_b, static_mask=static_mask, num_images=num_images)


def _position_and_refine(tracks, height, width, cfg, fe: dict, log, dev) -> Reconstruction:
    """Positioning back-end (glomap bearings, or LUD or linear positions with
    the optional nonlinear refinement) + shared refinement, from the
    front-end products in `fe`; traced, the spans `sfm.positions` and
    `sfm.ba`."""
    with profiling.span("sfm.positions", device=dev):
        pos = _positions(tracks, height, width, cfg, fe, log, dev)
    if isinstance(pos, Reconstruction):
        return pos
    params, q_est, t_est = pos
    with profiling.span("sfm.ba", device=dev):
        return _refine_and_finish(tracks, cfg, params, height, width, fe["num_images"],
                                  fe["sub"], fe["full2sub"], fe["obs"], fe["obs_t"], q_est,
                                  t_est, fe["V"], fe["N"], log, dev, anchor=fe["anchor"],
                                  focal_bounds=fe["focal_bounds"])


def _positions(tracks, height, width, cfg, fe: dict, log, dev):
    """Camera positions: (params, q_est, t_est) for `_refine_and_finish`, or
    a failed Reconstruction."""
    params, focal = fe["params"], fe["focal"]
    obs, obs_t = fe["obs"], fe["obs_t"]
    N, V, sub, R_abs = fe["N"], fe["V"], fe["sub"], fe["R_abs"]
    spairs, t_rel = fe["spairs"], fe["t_rel"]
    inl_mask, uv1, uv2, has_b = fe["inl_mask"], fe["uv1"], fe["uv2"], fe["has_b"]
    static_mask, num_images = fe["static_mask"], fe["num_images"]

    def T(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def norm(uv):
        return (uv - params[None, None, 2:4]) / focal

    if cfg.sfm_type == "glomap" or cfg.position.method == "glomap":
        # ---- direct global positioning over bearings with a joint focal ----
        from ..globalsfm.global_positioning import global_positioning_joint_focal

        duv = (obs_t.uv - params[2:4]).astype(np.float32)
        a_cam = np.concatenate([duv, np.zeros(duv.shape[:-1] + (1,), np.float32)], axis=-1)
        Rt = _np(R_abs)[obs_t.frame_idx]                       # [N, K, 3, 3]
        a_w = np.einsum("nkji,nkj->nki", Rt, a_cam)
        b_w = Rt[..., 2, :].copy()                             # R^T e_z rows
        p_est, _, _, f_est = global_positioning_joint_focal(
            V, T(a_w), T(b_w), obs.frame_idx, obs.mask, g0=1.0 / focal)
        q_est = rot.rotmat_to_quat(R_abs)
        t_est = se3.pose_from_center(q_est, p_est)
        params_g = params.copy()
        params_g[0] = params_g[1] = float(f_est)
        jp = T(params_g)
        X_chk = triangulate_tracks(q_est, t_est, jp, obs)
        _, valid_chk, err_chk = filter_observations(q_est, t_est, jp, X_chk, obs, 1e9, 0.0)
        med_err = _median(err_chk[obs.mask])
        frac_valid = float(valid_chk.sum()) / max(N, 1)
        log(f"[mapper] glomap positioning: focal {float(f_est):.1f} "
            f"(prior {focal:.1f}), median reproj {med_err:.1f}px, "
            f"{frac_valid:.2f} tracks valid")
        if med_err < 8.0 * cfg.ba.filter_max_reproj_error_px and frac_valid > 0.5:
            return params_g, q_est, t_est
        log("[mapper] glomap positioning rejected; falling back to LUD path")

    # ---- pairwise translation refinement (panoramic pairs carry no baseline)
    if not has_b.all():
        nb = int((~has_b).sum())
        if has_b.sum() < 3 or not largest_connected_component(V, spairs[has_b]).all():
            log(f"[mapper] translation graph disconnected without {nb} "
                "pure-rotation pairs; reconstruction failed")
            return _failed(num_images, params, height, width)
        log(f"[mapper] excluding {nb} pure-rotation pairs from translation stages")
    spairs_t = spairs[has_b]
    inl_t = inl_mask[has_b]
    et = T(spairs_t, torch.int64)
    w0 = directions_from_relative_poses(et, R_abs, T(t_rel[has_b], torch.float32))
    w_dir = refine_pairwise_translations(et, R_abs, T(norm(uv1[has_b])), T(norm(uv2[has_b])),
                                         T(inl_t), w0)

    # ---- 1DSfM MFAS filter ------------------------------------------------
    mkeep = mfas_position_filter(V, spairs_t, _np(w_dir), seed=cfg.seed)
    log(f"[mapper] MFAS filter kept {mkeep.sum()}/{len(mkeep)} pairs")
    if mkeep.sum() >= 3 and largest_connected_component(V, spairs_t[mkeep]).all():
        spairs_m = spairs_t[mkeep]
        w_m = w_dir[T(mkeep)]
    else:  # the filter would disconnect the graph; keep everything
        spairs_m, w_m = spairs_t, w_dir

    # ---- triplet scale constraints ------------------------------------------
    # The edge and triplet axes are padded to 256-multiples with weight-0
    # rows, as in the reference: the padding enters ADMM's stopping tolerance
    # (sqrt(3E + 3T), and the padded scales in ||s||), so it is part of the result.
    Em = len(spairs_m)
    em_pad = (-Em) % 256
    spairs_mp = np.pad(np.asarray(spairs_m), ((0, em_pad), (0, 0)))
    w_mp = torch.cat([w_m, torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(em_pad, 3)])
    emask_m = torch.cat([torch.ones(Em, device=dev), torch.zeros(em_pad, device=dev)])
    trip_constraints = None
    tris = np.zeros((0, 3), np.int32)
    if cfg.position.use_scale_constraints or cfg.position.method == "linear":
        tris = extract_triplets(spairs_m)
        if len(tris) > 2048:  # dense view graphs: cap the constraint set
            sel = np.random.default_rng(cfg.seed).choice(len(tris), 2048, replace=False)
            tris = tris[np.sort(sel)]
        if len(tris):
            edge_of = {(int(a), int(b)): e for e, (a, b) in enumerate(spairs_m)}
            tri_edges = np.array([[edge_of[(i, j)], edge_of[(i, k)], edge_of[(j, k)]]
                                  for i, j, k in tris], np.int32)
            sub_mask = static_mask[:, sub]
            xi, xj, xk, tmask = gather_triplet_points(
                TrackArrays(xy=tracks.xy[:, sub], mask=sub_mask), sub_mask, tris, seed=cfg.seed)
            t_pad = (-len(tris)) % 256
            tris_p = np.pad(tris, ((0, t_pad), (0, 0)))
            tri_edges_p = np.pad(tri_edges, ((0, t_pad), (0, 0)))
            xi, xj, xk = (np.pad(x, ((0, t_pad), (0, 0), (0, 0))) for x in (xi, xj, xk))
            tmask = np.pad(tmask, ((0, t_pad), (0, 0)))
            trip_constraints = triplet_baseline_constraints(
                R_abs, w_mp, T(tris_p, torch.int64), T(tri_edges_p, torch.int64),
                T((xi - params[2:4]) / focal), T((xj - params[2:4]) / focal),
                T((xk - params[2:4]) / focal), T(tmask),
                min_angle_deg=cfg.position.min_triangulation_angle_deg)
            nz = int((trip_constraints.weight > 0).sum())
            log(f"[mapper] {len(tris)} triplets, {nz} active scale constraints")

    # ---- positions: LUD (default) or linear-spectral, when triplets exist
    if cfg.position.method == "linear" and trip_constraints is not None:
        # padded triplet rows carry weight 0 and add empty row blocks
        p_est = estimate_positions_linear(V, T(spairs_mp, torch.int64), w_mp,
                                          T(tris_p, torch.int64), trip_constraints)
        log("[mapper] linear (spectral) position estimation done")
    else:
        p_est, _, lud_info = estimate_positions_lud(V, T(spairs_mp, torch.int64), w_mp, emask_m,
                                                    triplets=trip_constraints)
        log(f"[mapper] LUD ADMM: {lud_info['iters']} iters, "
            f"primal {lud_info['r_primal']:.2e} dual {lud_info['r_dual']:.2e}")
    if cfg.position.method == "nonlinear":
        # 1DSfM chordal refinement on top of the LUD solution, over the
        # unpadded edges
        p_est = refine_positions_nonlinear(V, T(spairs_m, torch.int64), w_m,
                                           torch.ones(len(spairs_m), device=dev), p_est)
        log("[mapper] nonlinear position refinement done")
    q_est = rot.rotmat_to_quat(R_abs)
    t_est = se3.pose_from_center(q_est, p_est)  # register: t = -R p
    return params, q_est, t_est


def _spread(q, t) -> float:
    c = _np(se3.camera_center(q, t))
    return float(np.linalg.norm(c - c.mean(0), axis=1).mean())


def _refine_and_finish(tracks, cfg, params, height, width, num_images, sub, full2sub,
                       obs, obs_t, q_est, t_est, V, N, log, dev, anchor=(0, 1),
                       focal_bounds=None):
    """Shared tail: triangulation + two-phase iterative refinement + view
    rescue + packing."""
    # scale gauge: pin the dominant component of a1's initial tvec
    if len(anchor) < 3:
        t_a1 = _np(t_est)[int(anchor[1])]
        anchor = (int(anchor[0]), int(anchor[1]), int(np.argmax(np.abs(t_a1))))
    px = cfg.ba.filter_max_reproj_error_px
    min_ang = cfg.ba.filter_min_tri_angle_deg
    jparams = torch.as_tensor(np.asarray(params), dtype=torch.float32, device=dev)
    X = triangulate_tracks(q_est, t_est, jparams, obs)
    # loose initial gate: the focal prior can be far off and BA refines it
    good, valid, _ = filter_observations(q_est, t_est, jparams, X, obs, 8.0 * px, min_ang)
    log(f"[mapper] initial triangulation: {int(valid.sum())}/{N} valid tracks")

    # BA runs on a capped, quality-ranked track subset; the full set is
    # re-triangulated and gated against the final poses below
    obs_full = obs
    subsampled = N > cfg.ba.max_tracks
    if subsampled:
        # ranked over the reference's 32768-bucketed track axis (zero scores
        # in the padding), so the selection among tied scores is the same
        n_pad = -(-N // _BUCKET) * _BUCKET - N
        nobs = _np(obs.mask.sum(1))
        score = np.pad(_np(valid).astype(np.int64) * 1000 + nobs, (0, n_pad))
        sel = np.sort(np.argpartition(-score, cfg.ba.max_tracks)[: cfg.ba.max_tracks])
        sel_t = torch.as_tensor(sel, device=dev)
        obs = TrackObs(obs.frame_idx[sel_t], obs.uv[sel_t], obs.mask[sel_t])
        X, good, valid = X[sel_t], good[sel_t], valid[sel_t]
        log(f"[mapper] BA refinement on {cfg.ba.max_tracks}/{N} ranked tracks")

    q_cur, t_cur = q_est, t_est
    # renormalize the scene to the initial camera spread after every round
    target_spread = _spread(q_cur, t_cur)
    thr = px

    def ba(q, t, X, jp, free, pm, tol):
        return bundle_adjust(
            q, t, jp, X, obs, free, pm, max_iterations=cfg.ba.max_num_iterations,
            loss_scale=cfg.ba.loss_scale, use_soft_l1=(cfg.ba.loss == "soft_l1"),
            refine_focal=cfg.ba.refine_focal_length, function_tolerance=tol,
            focal_bounds=focal_bounds)

    for phase, refine_rot in ((0, False), (1, True)):
        free = default_free_masks(V, refine_rotation=refine_rot, anchor=anchor, device=dev)
        prev_frac = -1.0
        # a round that drops kept-obs by > 0.1 is reverted and ends the phase
        snap = None
        for it in range(cfg.ba.max_refinements):
            if prev_frac >= 0:
                snap = (q_cur, t_cur, X, jparams, good, valid, thr)
            state = ba(q_cur, t_cur, X, jparams, free, valid.float(),
                       cfg.ba.function_tolerance_anneal if phase == 0
                       else cfg.ba.function_tolerance)
            q_cur, t_cur, X, jparams = state.q, state.t, state.X, state.params
            scale = target_spread / max(_spread(q_cur, t_cur), 1e-9)
            t_cur = t_cur * scale
            X = X * scale
            # retriangulate + complete + filter with a gate adapted to the
            # current error level (up to 8x in phase 0, strict late)
            X = triangulate_tracks(q_cur, t_cur, jparams, obs)
            _, _, errs_now = filter_observations(q_cur, t_cur, jparams, X, obs, 1e9, 0.0)
            med = _nanmedian(errs_now[obs.mask])
            if not np.isfinite(med):
                med = px
            cap = 8.0 if (phase == 0 or it == 0) else 1.0
            thr = float(np.clip(3.0 * med, px, cap * px))
            good, valid, errs = filter_observations(q_cur, t_cur, jparams, X, obs, thr, min_ang)
            frac = float(good.float().sum() / obs.mask.sum())
            log(f"[mapper] phase {phase} round {it}: cost={float(state.cost):.3e} "
                f"thr={thr:.2f}px kept-obs={frac:.4f} valid-tracks={int(valid.sum())} "
                f"lm-iters={state.iters}")
            if prev_frac >= 0 and frac < prev_frac - 0.1 and snap is not None:
                q_cur, t_cur, X, jparams, good, valid, thr = snap
                log(f"[mapper] phase {phase} round {it}: kept-obs collapsed "
                    f"{prev_frac:.3f} -> {frac:.3f}; reverted round, ending phase")
                break
            if abs(frac - prev_frac) < cfg.ba.refinement_change:
                break
            prev_frac = frac

    # ---- broken-view rescue (PnP re-registration): a view whose kept
    # fraction collapsed while the rest is consistent has a wrong pose
    fi_h, m_h = _np(obs.frame_idx), _np(obs.mask)
    g_h, v_h = _np(good), _np(valid)
    tot_v = np.bincount(fi_h[m_h], minlength=V)
    kept_v = np.bincount(fi_h[m_h & g_h], minlength=V)
    frac_v = kept_v / np.maximum(tot_v, 1)
    med_frac = float(np.median(frac_v[tot_v > 0])) if (tot_v > 0).any() else 0.0
    bad_views = np.nonzero((tot_v > 50) & (frac_v < 0.5 * med_frac) & (frac_v < 0.4))[0]
    if len(bad_views) and len(bad_views) <= max(2, V // 3):
        X_h, uv_h = _np(X), _np(obs.uv)
        jp_h = _np(jparams)
        pp_now, f_now = jp_h[2:4], float(jp_h[0])
        thr_n = float(np.float32((px / f_now) ** 2))
        CAP = 4096
        q_np, t_np = _np(q_cur).copy(), _np(t_cur).copy()
        n_fixed = 0
        for v in bad_views:
            rows, slots = np.nonzero((fi_h == v) & m_h & v_h[:, None])
            if len(rows) < 30:
                continue
            if len(rows) > CAP:
                pick = np.linspace(0, len(rows) - 1, CAP).astype(int)
                rows, slots = rows[pick], slots[pick]
            Xc = np.zeros((CAP, 3), np.float32)
            xc = np.zeros((CAP, 2), np.float32)
            mc = np.zeros(CAP, bool)
            Xc[:len(rows)] = X_h[rows]
            xc[:len(rows)] = (uv_h[rows, slots] - pp_now) / f_now
            mc[:len(rows)] = True
            res = estimate_pose_pnp(
                torch.as_tensor(Xc, device=dev), torch.as_tensor(xc, device=dev),
                torch.as_tensor(mc, device=dev), thr_n,
                u=torch.as_tensor(threefry_uniform(threefry_key(int(v)), (64, 6)), device=dev))
            n_inl = int(res.num_inliers)
            if n_inl >= 30 and n_inl >= 0.4 * len(rows):
                q_np[v] = _np(res.q)
                t_np[v] = _np(res.t)
                n_fixed += 1
        log(f"[mapper] view rescue: {len(bad_views)} low-support views "
            f"(median kept {med_frac:.2f}), {n_fixed} re-registered by PnP")
        if n_fixed:
            q_cur = torch.as_tensor(q_np, device=dev)
            t_cur = torch.as_tensor(t_np, device=dev)
            state = ba(q_cur, t_cur, X, jparams,
                       default_free_masks(V, refine_rotation=True, anchor=anchor, device=dev),
                       valid.float(), cfg.ba.function_tolerance)
            q_cur, t_cur, X, jparams = state.q, state.t, state.X, state.params
            t_cur = t_cur * (target_spread / max(_spread(q_cur, t_cur), 1e-9))
            X = triangulate_tracks(q_cur, t_cur, jparams, obs)
            good, valid, errs = filter_observations(q_cur, t_cur, jparams, X, obs, thr, min_ang)
            log(f"[mapper] post-rescue round: cost={float(state.cost):.3e} "
                f"valid-tracks={int(valid.sum())} lm-iters={state.iters}")

    if subsampled:
        # bring every track back in against the final geometry
        obs = obs_full
        X = triangulate_tracks(q_cur, t_cur, jparams, obs)
        good, valid, errs = filter_observations(q_cur, t_cur, jparams, X, obs, thr, min_ang)
        log(f"[mapper] full-set retriangulation: {int(valid.sum())}/{N} valid "
            f"tracks at thr {thr:.2f}px")
    else:
        _, _, errs = filter_observations(q_cur, t_cur, jparams, X, obs, px, min_ang)

    # ---- leave unregistered the views the reconstruction cannot explain ----
    good_h, valid_h = _np(good), _np(valid)
    fi_h2, m_h2 = obs_t.frame_idx, obs_t.mask
    tot2 = np.bincount(fi_h2[m_h2], minlength=V)
    kept2 = np.bincount(fi_h2[m_h2 & good_h & valid_h[:, None]], minlength=V)
    frac2 = kept2 / np.maximum(tot2, 1)
    med2 = float(np.median(frac2[tot2 > 0])) if (tot2 > 0).any() else 0.0
    drop = (tot2 > 50) & (frac2 < 0.25 * med2) & (frac2 < 0.25)
    reg_sub = ~drop
    if drop.any():
        if drop.sum() <= max(1, V // 8):
            log(f"[mapper] dropping {int(drop.sum())} unexplainable view(s) "
                f"{np.nonzero(drop)[0].tolist()} (kept fraction "
                f"{frac2[drop].round(2).tolist()} vs median {med2:.2f})")
            good_h = good_h & reg_sub[fi_h2]
        else:
            # a broad collapse is a failed solve, not a few bad frames
            log(f"[mapper] {int(drop.sum())} views below kept-fraction gate; "
                "keeping all (solve-level failure, not per-view)")
            reg_sub = np.ones(V, bool)

    # ---- expand back to full image indexing -------------------------------
    qvec = np.tile(np.array([1.0, 0, 0, 0], np.float32), (num_images, 1))
    tvec = np.zeros((num_images, 3), np.float32)
    qvec[sub] = _np(q_cur)
    tvec[sub] = _np(t_cur)
    registered = np.zeros(num_images, bool)
    registered[sub] = reg_sub
    frame_full = sub[obs_t.frame_idx.reshape(-1)].reshape(obs_t.frame_idx.shape)
    return Reconstruction(
        num_images=num_images, registered=registered, qvec=qvec, tvec=tvec,
        params=_np(jparams), height=height, width=width,
        points=_np(X),
        track_valid=valid_h & (good_h.sum(axis=1) >= 2),
        obs_frame_idx=frame_full.astype(np.int32),
        obs_uv=obs_t.uv,
        obs_mask=good_h,
        # float16 per-observation errors, as the reference stores them
        obs_error=_np(errs.half().float()),
        track_row=obs_t.track_row,
        support=float((good & valid[:, None]).float().sum() / obs.mask.sum()))
