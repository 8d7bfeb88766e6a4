"""Pipeline stages with the reference's on-disk contracts + skip-exists restart
(port of particlesfm_tpu/pipeline/stages.py).

The flow stage runs pair-indexed RAFT (optionally at reduced resolution,
with the photometric refinement inside the apply), the stride-2
composition fallback, and flow self-calibration ->
selfcal.json; then the trajectory stage (occlusion checks, slot-pool
tracker with path-consistency LM), the depth and motion-segmentation
stages, and the SfM stage (global mapper, reconstruction manager or
incremental mapper -> COLMAP model, converted outputs, stats).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..globalsfm.selfcal import estimate_focal_from_flows
from ..io import flo as flo_io
from ..io.images import read_depth_png16, write_depth_png16
from ..motionseg import segment_tracks
from ..ops.flow_ops import flow_check, stride2_compose_fallback
from ..tracks.engine import TrackerConfig, run_tracker
from ..tracks.store import TrackArrays, assemble_tracks
from ..geometry import cameras
from ..sfm.export import write_colmap_model, write_converted_outputs
from ..sfm.incremental import run_incremental_mapper
from ..sfm.manager import run_reconstruction_manager, write_models
from ..sfm.mapper import _failed, run_global_mapper
from ..sfm.stats import compute_model_stats, format_model_stats
from ..utils import profiling
from ..utils.config import Config


class MissingDepthError(RuntimeError):
    """No depth net and no precomputed depth PNGs: the reference's pipeline
    then treats the scene as static."""


def _flow_dir_complete(d: Path, expected: int) -> bool:
    return d.is_dir() and len(list(d.glob("*.flo"))) >= expected


def _write_flow_selfcal(result, height, width, out_dir: Path, cfg, log):
    """Self-calibrate the shared focal from the flow stack -> selfcal.json.

    Runs at the flow stage because flow-level correspondences measure focal
    better than tracker output; the SfM stage reads the JSON as its focal
    prior (`read_flow_selfcal`)."""
    p = Path(out_dir) / "selfcal.json"
    if not cfg.flow.selfcal or "flow_f" not in result:
        return
    if cfg.skip_exists and p.exists():
        return
    with profiling.span("flow.selfcal", device=result["flow_f"].device):
        info = estimate_focal_from_flows(result, height, width, seed=0)
        p.write_text(json.dumps(info, indent=2))
    log(f"[flow] self-calibrated focal {info['focal']:.1f} "
        f"(conf {info['confidence']:.2f}, dip {info['dip']:.2f}, "
        f"n {info['num_pairs']})")


def read_flow_selfcal(out_dir: Path, cfg) -> Optional[tuple]:
    """Focal from the flow stage's selfcal.json, if present and trustworthy.

    Returns (focal, bound_frac) -- bound_frac is the BA focal trust-region
    half-width the estimate's quality earns -- or None when untrustworthy."""
    p = Path(out_dir) / "selfcal.json"
    if not getattr(cfg.sfm, "selfcal_focal", True) or not p.exists():
        return None
    info = json.loads(p.read_text())
    # AND of all quality signals: on degenerate scenes either signal alone
    # admits a confidently wrong estimate
    ok = (
        info.get("interior", True)
        and info.get("num_pairs", 0) >= cfg.sfm.selfcal_min_pairs
        and info.get("dip", 1.0) <= cfg.sfm.selfcal_max_dip
        and info.get("confidence", 0.0) >= cfg.sfm.selfcal_min_conf
    )
    if ok:
        return float(info["focal"]), 0.15
    # marginal tier: a shallow-dip estimate with decent per-pair agreement is
    # still a better prior than the 1.2*max(h,w) heuristic, with a wider BA
    # trust region so a bad marginal estimate can be escaped
    marginal = (
        info.get("interior", True)
        and info.get("num_pairs", 0) >= cfg.sfm.selfcal_min_pairs
        and info.get("dip", 1.0) <= 0.8
        and info.get("confidence", 0.0) >= 0.5
    )
    if marginal:
        return float(info["focal"]), 0.30
    return None


def upload_frame_stack(images: np.ndarray, device) -> torch.Tensor:
    """The uint8 frame stack [T, H, W, 3] on `device`, uploaded once and
    shared by every pair block."""
    u8 = np.clip(np.round(np.asarray(images)), 0, 255).astype(np.uint8)
    return torch.from_numpy(u8).to(device)


def flow_stage(
    images: np.ndarray,            # [T, H, W, 3] float32
    out_dir: Path,
    cfg: Config,
    device,                        # the run's device: reused .flo stacks go there
    raft_apply: Optional[Callable] = None,   # (stack, ia, ib) -> flows [N, H, W, 2]
    device_stack=None,             # uploaded uint8 stack, or a thunk returning it
    log=print,
):
    """Pairwise forward/backward flow at stride 1 (and 2 unless disabled),
    then flow self-calibration -> selfcal.json.

    Computed flows are the apply's, as it returns them (refined there when
    the run refines); `device_stack` (`upload_frame_stack`) is needed only
    when some flow is computed.

    Returns {name: [npairs, H, W, 2] tensor on `device`} for flow_f, flow_b
    (+ flow_f2, flow_b2); with --keep_intermediate also writes them as .flo directories (the
    reference's RAFT-stage contract). Existing complete .flo directories are
    reused under --skip_exists.
    """
    T = images.shape[0]
    use_pc = not cfg.track.skip_path_consistency
    dirs = {"flow_f": 1, "flow_b": -1}
    if use_pc:
        dirs.update({"flow_f2": 2, "flow_b2": -2})
    flow_root = Path(out_dir) / "optical_flows"
    result = {}
    todo = []                      # (name, stride, dir, npairs) still to compute
    for name, stride in dirs.items():
        d = flow_root / name
        npairs = T - abs(stride)
        if cfg.skip_exists and _flow_dir_complete(d, npairs):
            log(f"[flow] {name}: reusing {npairs} existing .flo files")
            stack = np.stack(
                [flo_io.read_flo(p) for p in sorted(d.glob("*.flo"))[:npairs]])
            H, W = images.shape[1], images.shape[2]
            if stack.shape != (npairs, H, W, 2):
                raise RuntimeError(
                    f"flow stage: {d} holds flow of shape {stack.shape[1:3]}, "
                    f"expected {(H, W)} for {npairs} pairs — stale flow dir?")
            result[name] = torch.from_numpy(stack).to(device)
            continue
        todo.append((name, stride, d, npairs))
    if not todo:
        _write_flow_selfcal(result, images.shape[1], images.shape[2], out_dir, cfg, log)
        return result
    if raft_apply is None:
        raise RuntimeError(
            f"flow stage: no precomputed flow at {flow_root} and no RAFT "
            "weights provided (pass --raft_ckpt or precompute flow)")
    if callable(device_stack):
        device_stack = device_stack()
    # ONE pair list over every direction, so the blocks are full
    ia_all, ib_all = [], []
    for name, stride, d, npairs in todo:
        ia_all.append(np.arange(npairs) + (0 if stride > 0 else abs(stride)))
        ib_all.append(np.arange(npairs) + (abs(stride) if stride > 0 else 0))
    flows_all = raft_apply(device_stack, np.concatenate(ia_all), np.concatenate(ib_all))
    off = 0
    for name, stride, d, npairs in todo:
        result[name] = flows_all[off:off + npairs]
        off += npairs
    computed = {t[0] for t in todo}
    reused = [n for n in result if n not in computed]
    if cfg.flow.photometric_refine and reused:
        log(f"[flow] NOTE: flow reused from disk ({', '.join(reused)}) bypasses "
            "photometric refinement (external flow respected as-is)")
    if cfg.flow.stride2_compose_disagree_px > 0 and use_pc:
        _stride2_fallback(result, computed, cfg.flow.stride2_compose_disagree_px, log)

    _write_flow_selfcal(result, images.shape[1], images.shape[2], out_dir, cfg, log)
    # .flo contract writes only when the files outlive the run; f16 on the
    # way to the host, as the reference writes them (stages.py:278-299)
    for name, stride, d, npairs in todo:
        if not cfg.keep_intermediate:
            log(f"[flow] {name}: computed {npairs} pairs (batched, in-memory)")
            continue
        d.mkdir(parents=True, exist_ok=True)
        host = result[name].to(torch.float16).cpu().numpy().astype(np.float32)
        for i in range(npairs):
            flo_io.write_flo(d / f"{i:06d}.flo", host[i])
        log(f"[flow] {name}: computed {npairs} pairs (batched)")
    return result


def _stride2_fallback(result: dict, computed, tau: float, log):
    """The stride-2 safety net (FlowConfig.stride2_compose_disagree_px): each
    freshly computed stride-2 field falls back to the composition of its two
    stride-1 hops where they disagree by more than `tau` px. Flow read from
    disk is respected as-is. The blended fields stay on their device."""
    for name2, hop in (("flow_f2", "flow_f"), ("flow_b2", "flow_b")):
        if name2 not in computed or hop not in result:
            continue
        f1 = result[hop]
        # forward pair i: i -> i+1 -> i+2; backward pair i: i+2 -> i+1 -> i
        a, b = (f1[:-1], f1[1:]) if name2 == "flow_f2" else (f1[1:], f1[:-1])
        blended, used = stride2_compose_fallback(result[name2], a, b, disagree_px=tau)
        frac = float(used.to(torch.float32).mean())
        if frac > 0:
            log(f"[flow] {name2}: composed-stride-1 fallback on {100 * frac:.1f}% of pixels")
        result[name2] = blended


def tracking_stage(
    flows: dict,
    height: int,
    width: int,
    out_dir: Path,
    cfg: Config,
    device=None,
    log=print,
) -> TrackArrays:
    """Occlusion checks + tracker + path consistency -> trajectories/tracks.npz.

    Flow stacks may be tensors (kept on their device) or numpy arrays (moved
    to `device`)."""
    traj_dir = Path(out_dir) / "trajectories"
    traj_path = traj_dir / "tracks.npz"
    if cfg.skip_exists and traj_path.exists():
        log("[tracks] reusing existing tracks.npz")
        return TrackArrays.load(traj_path)
    traj_dir.mkdir(parents=True, exist_ok=True)

    def dev(x):
        return torch.as_tensor(x, device=device if not torch.is_tensor(x) else x.device)

    ff = dev(flows["flow_f"])
    with profiling.span("tracks.scan", device=ff.device):
        occ, _ = flow_check(ff, dev(flows["flow_b"]), cfg.track.flow_check_thres)
        use_pc = "flow_f2" in flows
        ff2, occ2 = None, None
        if use_pc:
            ff2 = dev(flows["flow_f2"])
            occ2, _ = flow_check(ff2, dev(flows["flow_b2"]), cfg.track.flow_check_thres)

        tcfg = TrackerConfig(
            sample_ratio=cfg.track.sample_ratio,
            capacity=cfg.track.capacity,
            path_consistency=use_pc,
        )
        out = run_tracker(ff, occ, ff2, occ2, tcfg, height, width)
    with profiling.span("tracks.assemble", device=ff.device):
        tracks = assemble_tracks(out, min_len=cfg.track.traj_min_len)
        tracks.save(traj_path)
    log(f"[tracks] {tracks.num_tracks} tracks over {tracks.num_frames} frames "
        f"(overflow={int(out.overflow)})")
    return tracks


def depth_stage(
    images: np.ndarray,
    out_dir: Path,
    cfg: Config,
    depth_apply: Optional[Callable] = None,   # (uint8 stack [T,H,W,3]) -> [T, H, W]
    device_stack=None,             # uploaded uint8 stack, or a thunk returning it
    log=print,
):
    """Per-frame relative depth in [0, 1] (16-bit PNG contract).

    Returns the depth stack [T, H, W] (a tensor on the apply's device, or an
    array read back from existing PNGs). Existing PNGs are reused under
    --skip_exists, and whenever no depth net is given."""
    d = Path(out_dir) / "depth"
    T = images.shape[0]
    existing = sorted(d.glob("*.png")) if d.is_dir() else []
    if len(existing) >= T and (cfg.skip_exists or depth_apply is None):
        log(f"[depth] reusing {T} existing depth PNGs")
        return np.stack([read_depth_png16(p) for p in existing[:T]])
    if depth_apply is None:
        raise MissingDepthError(
            f"depth stage: no precomputed depth at {d} and no depth weights provided")
    deps = depth_apply(device_stack() if callable(device_stack) else device_stack)
    # the PNGs are written only when they outlive the run; the seg stage
    # reads the in-memory stack either way
    if cfg.keep_intermediate:
        d.mkdir(parents=True, exist_ok=True)
        host = deps.cpu().numpy()
        for i in range(T):
            write_depth_png16(d / f"{i:06d}.png", host[i])
    log(f"[depth] computed {T} frames (batched)")
    return deps


def motionseg_stage(
    tracks: TrackArrays,
    depths,
    image_hw,
    out_dir: Path,
    cfg: Config,
    seg_apply: Optional[Callable] = None,
    log=print,
) -> TrackArrays:
    """Label tracks dynamic/static; writes trajectories_labeled/tracks.npz."""
    labeled_path = Path(out_dir) / "trajectories_labeled" / "tracks.npz"
    if cfg.skip_exists and labeled_path.exists():
        log("[motionseg] reusing existing labeled tracks")
        return TrackArrays.load(labeled_path)
    if seg_apply is None:
        raise RuntimeError("motion-seg stage: no segmentation weights provided")

    # decision threshold: the checkpoint's calibrated value (sidecar) unless
    # the config was set away from the reference default 0.5
    thr = cfg.motionseg.threshold
    side = getattr(seg_apply, "threshold", None)
    if side is not None and abs(thr - 0.5) < 1e-9:
        thr = float(side)
        log(f"[motionseg] using checkpoint-calibrated threshold {thr}")
    labeled = segment_tracks(
        seg_apply, tracks, depths, image_hw,
        window_size=cfg.motionseg.window_size,
        traj_max_num=cfg.motionseg.traj_max_num,
        threshold=thr,
        log=log,
    )
    labeled_path.parent.mkdir(parents=True, exist_ok=True)
    labeled.save(labeled_path)
    frac = float(labeled.labels[labeled.mask].mean()) if labeled.mask.any() else 0.0
    log(f"[motionseg] dynamic fraction: {frac:.3f}")
    return labeled


def sfm_stage(
    tracks: TrackArrays,
    height: int,
    width: int,
    out_dir: Path,
    cfg: Config,
    device,
    image_names=None,
    log=print,
):
    """SfM -> sfm/model (COLMAP bins), colmap_outputs_converted/ and
    sfm/stats.txt. sfm_type "incremental" runs the incremental mapper and
    writes one model; otherwise the global mapper runs, through the
    reconstruction manager unless multiple_models is off. The focal prior is
    the flow stage's selfcal.json when it is trustworthy. The mappers run on
    `device`."""
    model_dir = Path(out_dir) / "sfm" / "model"
    if cfg.skip_exists and (model_dir / "images.bin").exists():
        log("[sfm] reusing existing model")
        return None
    params = None
    bound_frac = None
    cal = read_flow_selfcal(out_dir, cfg)
    if cal is not None:
        f_cal, bound_frac = cal
        params = cameras.make_default_params(height, width).numpy()
        log(f"[sfm] focal prior from flow self-calibration: {f_cal:.1f} "
            f"(heuristic {params[0]:.1f}, BA trust region +-{bound_frac:.0%})")
        params[0] = params[1] = f_cal
    models = None
    if cfg.sfm.sfm_type == "incremental":
        # the reference's incremental mode runs one model (multiple_models=0)
        rec = run_incremental_mapper(tracks, height, width, cfg.sfm, params=params, log=log,
                                     device=device)
    elif cfg.sfm.multiple_models:
        models = run_reconstruction_manager(
            tracks, height, width, cfg.sfm, max_models=cfg.sfm.max_models,
            params=params, log=log, focal_bound_frac=bound_frac, device=device)
    else:
        rec = run_global_mapper(tracks, height, width, cfg.sfm, params=params, log=log,
                                focal_bound_frac=bound_frac, device=device)
    with profiling.span("sfm.export", device=device):
        if models is not None:
            rec = write_models(models, model_dir, image_names, log=log)
            if rec is None:
                rec = _failed(tracks.num_frames,
                              cameras.make_default_params(height, width).numpy(), height, width)
                write_colmap_model(rec, model_dir, image_names)
        else:
            write_colmap_model(rec, model_dir, image_names)
        write_converted_outputs(rec, Path(out_dir) / "colmap_outputs_converted", image_names)
        stats = compute_model_stats(rec)
        log(format_model_stats(stats))
        with open(Path(out_dir) / "sfm" / "stats.txt", "w") as f:
            f.write(format_model_stats(stats) + "\n")
    return rec
