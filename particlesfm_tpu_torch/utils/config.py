"""Single config tree for the whole pipeline.

Replaces upstream ParticleSfM's three disjoint systems (argparse in
run_particlesfm.py:121-158, YAML attribute-objects in
motion_seg/core/utils/utils.py:27-35, boost program_options in
sfm/gmapper/src/util/option_manager.cc) with one dataclass tree
that is CLI-overridable with dotted keys and serialized next to outputs.

A copy of particlesfm_tpu/utils/config.py: the field tree, defaults and
override rules are identical, so both packages write the same config.json.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple


@dataclass
class FlowConfig:
    # RAFT-class flow net (reference: third_party/RAFT fork, raft-things weights)
    # GRU iterations; None = the count recorded in the checkpoint meta.
    # Default 8: measured EPE-identical to 12 on the acceptance set (raw
    # s1 0.584 vs 0.605, refined 0.298 vs 0.312) at 1.5x the speed — the
    # lookup is the per-iteration cost on TPU, so iterations are expensive
    iters: Optional[int] = 8
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    small: bool = False
    checkpoint: Optional[str] = None
    dtype: str = "bfloat16"
    # pairs per device per dispatch: big enough to amortize per-dispatch
    # latency, small enough that the full-res correlation volumes fit HBM
    # (~200 MB/pair f32 at 1024x436). Block 16 was tried and REVERTED: it
    # changed the bf16 flow numerics enough to cascade into a 2.8x protocol-
    # scale ATE regression (0.0028 -> 0.0078 on seq_01_dyn, A/B-bisected
    # round 4) while saving ~nothing end-to-end.
    per_device: int = 8
    # net inference resolution as a fraction of the input (flow/infer.py):
    # the correlation lookup is gather-bound on TPU so 0.5 is ~4x cheaper;
    # full-resolution photometric refinement recovers the sub-pixel detail
    infer_scale: float = 1.0
    # stride-2 composition fallback (ops.flow_ops.stride2_compose_fallback),
    # disabled by default after end-to-end measurement: it fixes the net's
    # large-displacement stride-2 tail (20 px -> 1.3 px EPE on fast-motion
    # pairs), but those refs are already excluded downstream by the tracker's
    # |flow02| < upper_flow gate, while at occlusion/motion boundaries the
    # through-occlusion composition corrupts refs the net got right —
    # measured ATE 0.017 -> 0.220 at protocol scale with it on. Kept as an
    # option for flow checkpoints with in-range stride-2 failures. 0 = off.
    stride2_compose_disagree_px: float = 0.0
    # photometric sub-pixel refinement of freshly computed net flow
    # (flow/refine.py): damped Lucas-Kanade GN against the actual image pair.
    # Removes the net's spatially structured sub-pixel bias, which random-error
    # metrics miss but metric SfM inherits (measured: F-based focal
    # self-calibration 15% high on raw net flow, 2% after refinement; EPE
    # 0.45 -> 0.24 at protocol scale). Applied only to freshly computed flow.
    photometric_refine: bool = True
    # window-annealing schedule, tuple of (iters, window_sigma, window_radius):
    # wide-window phase pulls structured bias out, tight phase sharpens the
    # subpixel optimum (measured: EPE 0.237 fixed-window -> 0.217, selfcal
    # focal +3.3% -> +1.1% of GT). More total iterations over-fit the robust
    # threshold and slowly degrade (measured).
    refine_schedule: Tuple = ((2, 3.5, 7), (3, 1.5, 3))
    refine_max_total_px: float = 3.0    # trust region around the net's flow
    # shared-focal self-calibration from refined flow correspondences
    # (globalsfm/selfcal.py), persisted as selfcal.json for the SfM stage
    selfcal: bool = True


@dataclass
class DepthConfig:
    # MiDaS-class relative depth net (reference: third_party/MiDaS fork,
    # run_particlesfm.py:55-57); consumed only by motion-seg featurization
    base: int = 32
    checkpoint: Optional[str] = None


@dataclass
class TrackConfig:
    # trajectory engine (reference defaults: run_particlesfm.py:124-129)
    sample_ratio: int = 2
    flow_check_thres: float = 1.0
    traj_min_len: int = 3
    skip_path_consistency: bool = False
    upper_flow: float = 20.0            # flow02 gate (trajectory.py:161-179)
    gn_iters: int = 12                  # path-consistency LM iterations (single-eval)
    capacity: int = 1 << 17             # active-slot pool size
    max_tracks: int = 100_000           # sample_inside_window cap (trajectory_base.cpp:150)


@dataclass
class MotionSegConfig:
    window_size: int = 10
    traj_max_num: int = 100_000
    resolution: Tuple[int, int] = (240, 424)   # (h, w), configs/example_test.yaml
    threshold: float = 0.5
    checkpoint: Optional[str] = None
    # model hyperparams (traj_oa_depth.py)
    d_model: int = 16
    nhead: int = 4
    num_layers: int = 2
    dim_feedforward: int = 64
    oan_channels: int = 128
    oan_depth: int = 8
    oan_clusters: int = 100


@dataclass
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-4
    epochs: int = 50
    batch_size: int = 4
    resolution: Tuple[int, int] = (272, 480)
    seed: int = 0


@dataclass
class RotationAveragingConfig:
    # reference: robust_rotation_estimator.{h,cc} + option_manager.cc defaults
    max_num_l1_iterations: int = 5
    l1_step_convergence_threshold: float = 0.001
    max_num_irls_iterations: int = 100
    irls_step_convergence_threshold: float = 0.001
    irls_loss_parameter_sigma_deg: float = 5.0


@dataclass
class PositionAveragingConfig:
    # reference: least_unsquared_deviation_position_estimator + option_manager.cc
    method: str = "lud"                  # lud | linear | nonlinear
    max_num_iterations: int = 400
    convergence_criterion: float = 1e-4
    use_scale_constraints: bool = True
    min_triangulation_angle_deg: float = 2.0


@dataclass
class TriangulationConfig:
    # reference: incremental_triangulator.h:46-89
    create_max_angle_error_deg: float = 2.0
    continue_max_angle_error_deg: float = 2.0
    merge_max_reproj_error_px: float = 4.0
    complete_max_reproj_error_px: float = 4.0
    min_angle_deg: float = 1.5
    max_transitivity: int = 1


@dataclass
class BundleAdjustmentConfig:
    # reference: controllers/global_mapper.h:36-69 + optim/bundle_adjustment.h
    max_num_iterations: int = 50
    max_refinements: int = 5
    # stop a refinement phase once kept-obs moves less than this between
    # rounds: measured at protocol scale, rounds beyond the plateau change
    # kept-obs by <2e-3 and the pose by nothing, at ~4.4 s/round
    refinement_change: float = 2e-3
    loss: str = "soft_l1"
    loss_scale: float = 1.0
    # LM early-exit tolerance (Ceres function_tolerance default 1e-6,
    # bundle_adjustment.h:48-102). The annealed phase-0 rounds re-triangulate
    # and re-gate right after BA, so sub-1e-5 precision there is wasted work
    # (the round-3 hardwired 1e-7 meant every round ran the full 50 LM
    # iterations at ~90 ms each at protocol scale)
    function_tolerance: float = 1e-6
    function_tolerance_anneal: float = 1e-5
    refine_focal_length: bool = True
    refine_extra_params: bool = True
    filter_max_reproj_error_px: float = 4.0
    filter_min_tri_angle_deg: float = 1.5
    # cap on tracks inside the LM refinement loop. TPU memory tiling pads the
    # trailing dims of the [N, K, 6, 6]-class block tensors to (8, 128) — 28x —
    # so a protocol-scale problem (227k tracks) would demand ~19 GB per buffer.
    # Pose/focal accuracy saturates far below this cap for <=few-hundred-camera
    # scenes; the FULL track set is re-triangulated and gated against the final
    # poses after the loop, so the reconstruction still carries every track.
    max_tracks: int = 32768


@dataclass
class SfmConfig:
    sfm_type: str = "global"             # global | incremental | glomap-mode
    # recover every covisibility component into numbered model subdirs and pick
    # the largest (reconstruction_manager.h:41-78 + main_sfm.py:52-93); the
    # reference's incremental mode runs with multiple_models=0 (main_sfm.py:95-125)
    multiple_models: bool = True
    max_models: int = 4
    min_num_matches: int = 15
    # covisibility-pair temporal span cap (0 = unlimited). The reference's
    # match graph is effectively banded (traj_to_matches samples inside
    # sliding windows); our dense tracks keep >=15 common tracks across 40+
    # frame baselines whose overfit two-view geometry biases averaging.
    # Measured (cached-track A/B, seq_01_dyn): complete graph 0.315 ATE /
    # 283 s; span 10 -> 0.064 / 102 s (kept-err leaves the ~1 px warped basin
    # for ~0.3-0.5 px). 0 = unlimited.
    max_pair_span: int = 10
    sample_k: int = 20                   # matches per track (matches_from_flow.py:53)
    remove_dynamic: bool = True
    # seg-label geometry gate: segmentation labels are advisory, not binding —
    # a seg-flagged track whose correspondences are epipolar-consistent inliers
    # across many verified pairs is rescued (kept static). The net can
    # over-trigger on out-of-domain sequences (measured precision ~0.09 on
    # protocol-scale tracker tracks, where ungated labels cost ATE 0.43 vs
    # 0.16 without labels); geometry has direct per-track evidence and
    # overrides it. Movers geometry cannot see (epipolar-degenerate motion)
    # keep their low inlier rates only in some pairs and are still removed.
    seg_geometry_gate: bool = True
    seg_rescue_inlier_rate: float = 0.9
    seg_rescue_min_samples: int = 6
    # shared-focal self-calibration (globalsfm/selfcal.py): replace the
    # heuristic 1.2*max(h,w) focal prior with an estimate from the data when
    # no intrinsics are supplied. The pipeline prefers the flow-level estimate
    # (selfcal.json written by the flow stage — flow correspondences measure
    # focal better than tracker output, whose path-consistency compounds
    # per-step flow bias); the mapper falls back to pair-tensor (track-level)
    # self-calibration for library callers. Gated on estimate quality.
    selfcal_focal: bool = True
    selfcal_min_pairs: int = 16
    selfcal_min_conf: float = 0.3        # per-pair agreement confidence AND
    selfcal_max_dip: float = 0.5         # a real aggregated-curve dip (both
                                         # must hold: degenerate near-planar
                                         # pure-translation scenes pass either
                                         # single signal with a wrong focal)
    geometric_verification_max_error_px: float = 4.0
    geometric_verification_min_inlier_ratio: float = 0.1
    geometric_verification_min_num_inliers: int = 15
    # learning-free dynamic-track fallback: tracks whose correspondences are
    # consistently REJECTED by the pairwise epipolar RANSAC are treated as
    # dynamic (complements the learned motion segmentation; no reference
    # equivalent — the reference relies entirely on the trained net)
    geometric_dynamic_filter: bool = True
    geometric_dynamic_max_inlier_rate: float = 0.3
    geometric_dynamic_min_samples: int = 4
    # per-pair sequential two-model RANSAC + cross-pair motion clustering:
    # catches the slow-large-object blended-geometry case the epipolar-voting
    # filter cannot (the blend makes dynamic tracks pairwise inliers on short
    # baselines; wide-baseline pairs separate the populations, and the cluster
    # with the wider spatial coverage is kept as static). When tracks are
    # flagged by either filter, the pairwise poses are RE-estimated with those
    # tracks' correspondences removed, un-blending the relative geometry.
    two_model_ransac: bool = True
    two_model_min_votes: int = 3
    two_model_max_dynamic_fraction: float = 0.5
    # two-view degenerate-configuration classification (two_view_geometry.h:48-67):
    # watermark pairs dropped, planar pairs repose from H, panoramic pairs
    # contribute rotation only
    classify_degenerate: bool = True
    max_H_inlier_ratio: float = 0.8
    watermark_min_inlier_ratio: float = 0.7
    panoramic_max_t_mag: float = 2e-2
    # pre-averaging loop-consistency gate: drop pairs whose median triplet
    # loop-closure error (vs shorter sub-pairs) exceeds this (0 disables).
    # Wide temporal-baseline pairs can carry junk two-view geometry that
    # clears the inlier gates; see mapper.py / graph.loop_consistency_filter.
    pre_orientation_filter_deg: float = 0.0   # 0 = ungated first start
    # multi-start convergence test: a first-start model whose kept
    # observations average above this reprojection error is not at the flow
    # noise floor (~0.25 px measured); try the loop-gated view graph too
    # noise floor measured ~0.25 px, warped basins 0.8-1.3 px; 0.65 leaves
    # margin below the warped band without re-solving 0.5-0.6 px models whose
    # banded-graph gated restart is a no-op (r5 sweep: identical scores)
    multi_start_err_px: float = 0.65
    # residual models below this image count are not worth a mapper pass
    # (COLMAP mapper min_model_size parity)
    min_model_size: int = 10
    filter_max_orientation_error_deg: float = 10.0
    rotation: RotationAveragingConfig = field(default_factory=RotationAveragingConfig)
    position: PositionAveragingConfig = field(default_factory=PositionAveragingConfig)
    triangulation: TriangulationConfig = field(default_factory=TriangulationConfig)
    ba: BundleAdjustmentConfig = field(default_factory=BundleAdjustmentConfig)
    seed: int = 100


@dataclass
class ParallelConfig:
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclass
class Config:
    image_dir: Optional[str] = None
    output_dir: Optional[str] = None
    assume_static: bool = False
    skip_sfm: bool = False
    skip_exists: bool = False
    keep_intermediate: bool = False
    flow: FlowConfig = field(default_factory=FlowConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    motionseg: MotionSegConfig = field(default_factory=MotionSegConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    sfm: SfmConfig = field(default_factory=SfmConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


def _to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(x) for x in obj]
    return obj


def _from_dict(cls, data):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or (isinstance(f.type, type) and dataclasses.is_dataclass(f.type)):
            kwargs[f.name] = _from_dict(f.type, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg: Config, path) -> None:
    Path(path).write_text(json.dumps(_to_dict(cfg), indent=2))


def load_config(path) -> Config:
    return _from_dict(Config, json.loads(Path(path).read_text()))


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply dotted-key overrides like {'sfm.ba.max_num_iterations': 20}."""
    for key, value in overrides.items():
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        if cur is not None and not isinstance(value, type(cur)) and not (
            isinstance(cur, (int, float)) and isinstance(value, (int, float))
        ):
            value = type(cur)(value)
        setattr(obj, parts[-1], value)
    return cfg
