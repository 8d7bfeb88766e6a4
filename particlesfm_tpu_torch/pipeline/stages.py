"""Pipeline stages with the reference's on-disk contracts + skip-exists restart
(port of particlesfm_tpu/pipeline/stages.py:100-354).

This slice ports the flow and trajectory stages: pair-indexed RAFT with fused
photometric refinement, occlusion checks, and the slot-pool tracker with
path-consistency LM. Stages the port does not have yet raise
NotImplementedError (`require_ported`) instead of being skipped.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..io import flo as flo_io
from ..ops.flow_ops import flow_check
from ..tracks.engine import TrackerConfig, run_tracker
from ..tracks.store import TrackArrays, assemble_tracks
from ..utils.config import Config


def require_ported(cfg: Config) -> None:
    """Raise NotImplementedError naming the first stage `cfg` asks for that
    the port does not have yet."""
    missing = []
    if cfg.flow.selfcal:
        missing.append("flow self-calibration (set flow.selfcal=false)")
    if cfg.flow.stride2_compose_disagree_px > 0:
        missing.append("stride-2 composition fallback "
                       "(flow.stride2_compose_disagree_px > 0)")
    if not cfg.assume_static:
        missing.append("depth + motion segmentation (pass --assume_static)")
    if not cfg.skip_sfm:
        missing.append("global SfM (pass --skip_sfm)")
    if missing:
        raise NotImplementedError(
            "particlesfm_tpu_torch does not port these stages yet: " + "; ".join(missing))


def _flow_dir_complete(d: Path, expected: int) -> bool:
    return d.is_dir() and len(list(d.glob("*.flo"))) >= expected


def upload_frame_stack(images: np.ndarray, device) -> torch.Tensor:
    """The uint8 frame stack [T, H, W, 3] on `device`, uploaded once and
    shared by every pair block."""
    u8 = np.clip(np.round(np.asarray(images)), 0, 255).astype(np.uint8)
    return torch.from_numpy(u8).to(device)


def flow_stage(
    images: np.ndarray,            # [T, H, W, 3] float32
    out_dir: Path,
    cfg: Config,
    raft_apply: Optional[Callable] = None,   # (stack, ia, ib) -> flows [N, H, W, 2]
    device_stack=None,             # uploaded uint8 stack, or a thunk returning it
    log=print,
):
    """Pairwise forward/backward flow at stride 1 (and 2 unless disabled).

    Returns {name: [npairs, H, W, 2]} for flow_f, flow_b (+ flow_f2, flow_b2);
    with --keep_intermediate also writes them as .flo directories (the
    reference's RAFT-stage contract). Existing complete .flo directories are
    reused under --skip_exists.
    """
    require_ported(cfg)
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
            result[name] = stack
            continue
        todo.append((name, stride, d, npairs))
    if not todo:
        return result
    if raft_apply is None:
        raise RuntimeError(
            f"flow stage: no precomputed flow at {flow_root} and no RAFT "
            "weights provided (pass --raft_ckpt or precompute flow)")
    if cfg.flow.photometric_refine and not getattr(raft_apply, "refines", False):
        raise NotImplementedError(
            "flow stage: photometric refinement outside the flow apply is not "
            "ported; use flow.infer.load_flow_apply_pairs(refine_schedule=...)")
    if callable(device_stack):
        device_stack = device_stack()
    if device_stack is None:        # the apply moves the stack to its device
        device_stack = upload_frame_stack(images, "cpu")
    # ONE pair list over every direction, so the blocks are full
    ia_all, ib_all = [], []
    for name, stride, d, npairs in todo:
        ia_all.append(np.arange(npairs) + (0 if stride > 0 else abs(stride)))
        ib_all.append(np.arange(npairs) + (abs(stride) if stride > 0 else 0))
    t0 = time.perf_counter()
    flows_all = raft_apply(device_stack, np.concatenate(ia_all), np.concatenate(ib_all))
    if flows_all.is_cuda:
        torch.cuda.synchronize(flows_all.device)
    log(f"[flow] net+refine: {time.perf_counter() - t0:.3f}s for "
        f"{flows_all.shape[0]} pairs")
    off = 0
    for name, stride, d, npairs in todo:
        result[name] = flows_all[off:off + npairs]
        off += npairs
    if cfg.flow.photometric_refine:
        log(f"[flow] photometric refinement fused into inference "
            f"(schedule {cfg.flow.refine_schedule})")

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

    t0 = time.perf_counter()
    ff = dev(flows["flow_f"])
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
    if out.positions.is_cuda:
        torch.cuda.synchronize(out.positions.device)
    t1 = time.perf_counter()
    tracks = assemble_tracks(out, min_len=cfg.track.traj_min_len)
    t2 = time.perf_counter()
    tracks.save(traj_path)
    log(f"[tracks] scan {t1 - t0:.1f}s, fetch+assemble {t2 - t1:.1f}s, "
        f"save {time.perf_counter() - t2:.1f}s")
    log(f"[tracks] {tracks.num_tracks} tracks over {tracks.num_frames} frames "
        f"(overflow={int(out.overflow)})")
    return tracks
