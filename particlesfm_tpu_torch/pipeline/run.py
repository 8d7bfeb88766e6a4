"""Pipeline orchestrator + CLI (port of particlesfm_tpu/pipeline/run.py).

Same three input modes (--image_dir+--output_dir, --workspace_dir with an
images subfolder, --root_dir looping over sequences), same stage toggles and
hyperparameter defaults, same config tree and `--set` overrides, same output
layout — so either package's stages can pick up the other's outputs. The
port runs flow (with self-calibration), trajectories, depth, motion
segmentation and SfM (global, glomap-mode or incremental), with every option
the JAX CLI accepts. Runs on CUDA unless `--device cpu` is given.

Usage:
    python -m particlesfm_tpu_torch.pipeline.run --image_dir IMG --output_dir OUT
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..io.images import load_image_stack
from ..parallel.mesh import Mesh, mesh_for
from ..utils.config import Config, apply_overrides, save_config
from ..utils.profiling import StageTimer
from . import stages


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ParticleSfM pipeline (PyTorch/CUDA port)")
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--workspace_dir", type=str, default=None)
    p.add_argument("--image_folder", type=str, default="images")
    p.add_argument("--root_dir", type=str, default=None)
    # stage toggles (upstream run_particlesfm.py:131-138)
    p.add_argument("--assume_static", action="store_true")
    p.add_argument("--skip_sfm", action="store_true")
    p.add_argument("--skip_path_consistency", action="store_true")
    p.add_argument("--skip_exists", action="store_true")
    p.add_argument("--keep_intermediate", action="store_true")
    # hyperparams (upstream run_particlesfm.py:124-129)
    p.add_argument("--sample_ratio", type=int, default=2)
    p.add_argument("--flow_check_thres", type=float, default=1.0)
    p.add_argument("--traj_min_len", type=int, default=3)
    p.add_argument("--window_size", type=int, default=10)
    p.add_argument("--traj_max_num", type=int, default=100000)
    p.add_argument("--sfm_type", type=str, default="global",
                   choices=["global", "incremental", "glomap"])
    # weights
    p.add_argument("--raft_ckpt", type=str, default=None)
    p.add_argument("--seg_ckpt", type=str, default=None)
    p.add_argument("--depth_ckpt", type=str, default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set flow.selfcal=false "
                        "(values parse as JSON, falling back to string)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    return p


def config_from_args(args) -> Config:
    cfg = Config()
    cfg.assume_static = args.assume_static
    cfg.skip_sfm = args.skip_sfm
    cfg.skip_exists = args.skip_exists
    cfg.keep_intermediate = args.keep_intermediate
    cfg.track.sample_ratio = args.sample_ratio
    cfg.track.flow_check_thres = args.flow_check_thres
    cfg.track.traj_min_len = args.traj_min_len
    cfg.track.skip_path_consistency = args.skip_path_consistency
    cfg.motionseg.window_size = args.window_size
    cfg.motionseg.traj_max_num = args.traj_max_num
    cfg.sfm.sfm_type = args.sfm_type
    cfg.flow.checkpoint = args.raft_ckpt
    cfg.motionseg.checkpoint = args.seg_ckpt
    cfg.depth.checkpoint = args.depth_ckpt
    if getattr(args, "overrides", None):
        ov = {}
        for item in args.overrides:
            key, _, raw = item.partition("=")
            try:
                ov[key] = json.loads(raw)
            except json.JSONDecodeError:
                ov[key] = raw
        apply_overrides(cfg, ov)
    return cfg


_CKPT_DIR = Path(__file__).resolve().parents[2] / "checkpoints"
DEFAULT_SEG_CKPT = _CKPT_DIR / "motionseg_synth3d.msgpack"
DEFAULT_RAFT_CKPT = _CKPT_DIR / "raft_synth.msgpack"
DEFAULT_DEPTH_CKPT = _CKPT_DIR / "depth_synth.msgpack"

# Loader memo across run_pipeline calls: a multi-sequence sweep (--root_dir)
# re-enters run_pipeline per sequence, and each loader would parse its
# msgpack and build its net again. Keyed on checkpoint path + mtime (a
# long-lived process that retrains or overwrites a checkpoint must not keep
# serving stale weights), the config fields that change the apply, and the
# mesh's device tuple: applies on other devices are different entries.
_APPLY_CACHE: dict = {}


def _ckpt_key(ckpt) -> tuple:
    try:
        return (str(ckpt), os.path.getmtime(ckpt))
    except OSError:
        return (str(ckpt), None)


def _memo(key, build):
    if key not in _APPLY_CACHE:
        _APPLY_CACHE[key] = build()
    return _APPLY_CACHE[key]


def _as_mesh(device):
    """A Mesh as is; a device as the mesh an entry point given it runs on
    (every visible card for a bare "cuda", else the device alone)."""
    return device if isinstance(device, Mesh) else mesh_for(device)


def _load_raft_apply(cfg: Config, device):
    """Pair-indexed flow apply with refinement fused after the net, over
    the mesh of `device` (a Mesh or a device, `_as_mesh`); defaults to the
    repo's compact checkpoint."""
    ckpt = cfg.flow.checkpoint
    if ckpt is None and DEFAULT_RAFT_CKPT.exists():
        ckpt = str(DEFAULT_RAFT_CKPT)
    if ckpt is None:
        return None
    from ..flow.infer import load_flow_apply_pairs

    schedule = (
        tuple(tuple(p) for p in cfg.flow.refine_schedule)
        if cfg.flow.photometric_refine else None
    )
    mesh = _as_mesh(device)
    key = ("raft", _ckpt_key(ckpt), cfg.flow.iters, cfg.flow.per_device,
           cfg.flow.infer_scale, schedule, cfg.flow.refine_max_total_px, mesh.key())
    return _memo(key, lambda: load_flow_apply_pairs(
        ckpt, iters=cfg.flow.iters, mesh=mesh, per_device=cfg.flow.per_device,
        scale=cfg.flow.infer_scale, refine_schedule=schedule,
        refine_max_total=cfg.flow.refine_max_total_px,
    ))


def _load_depth_apply(cfg: Config, device):
    """Depth apply from a checkpoint (default: the repo's DepthNet) over
    the mesh of `device` (`_as_mesh`): `apply(stack) -> [T, H, W]` on the
    mesh's entry 0, normalized per frame to [0, 1] and rounded to float16
    and back, as the reference hands it to the seg stage. `stack` is the
    uint8 frame stack [T, H, W, 3]."""
    ckpt = cfg.depth.checkpoint
    if ckpt is None and DEFAULT_DEPTH_CKPT.exists():
        ckpt = str(DEFAULT_DEPTH_CKPT)
    if ckpt is None:
        return None
    mesh = _as_mesh(device)
    return _memo(("depth", _ckpt_key(ckpt), cfg.depth.base, mesh.key()),
                 lambda: _build_depth_apply(ckpt, cfg.depth.base, mesh))


def _build_depth_apply(ckpt, base: int, device):
    """Frames run in blocks of 4 per mesh entry (4 * mesh size in all,
    reference run.py:176-180): each block is split into groups of 4, one
    per entry, each on that entry's DepthNet replica; the depths are
    gathered on entry 0."""
    from ..io.checkpoint import depth_state_dict_from_jax, load_msgpack
    from ..models.depth import DepthNet, normalize_depth

    mesh = _as_mesh(device)
    blob = load_msgpack(ckpt)
    sd = depth_state_dict_from_jax(blob["params"], blob.get("batch_stats", {}))
    models = {}
    for d in mesh.distinct():
        model = DepthNet(base=base)
        model.load_state_dict(sd, strict=True)
        models[d] = model.to(d).eval()
    devs = mesh.flat
    per = 4

    @torch.inference_mode()
    def apply(stack):
        stack = torch.as_tensor(stack)
        stacks = {d: stack.to(d) for d in models}
        out = []
        for g, lo in enumerate(range(0, stack.shape[0], per)):
            d = devs[g % len(devs)]
            x = stacks[d][lo:lo + per].to(torch.float32).permute(0, 3, 1, 2).contiguous()
            out.append(normalize_depth(models[d](x)).to(torch.float16).to(torch.float32))
        return torch.cat([o.to(devs[0]) for o in out])

    return apply


def _load_seg_apply(cfg: Config, device):
    """Motion-seg apply from a checkpoint (default: the repo's TrajOADepth)
    with a replica on each device of the mesh of `device` (`_as_mesh`):
    `apply(traj, depth, valid) -> logits [B, K]`, computed on the device of
    `depth` when it is a tensor on one of the mesh's devices (how
    `segment_tracks` runs each window shard on its device), else on the
    mesh's entry 0.

    A sidecar <ckpt>.json may carry {"input_hw": [h, w]} (the model's depth
    resolution; depth maps are resized to it on the fly) and a calibrated
    "threshold". traj arrives as u16 fixed point (`accepts_u16`)."""
    ckpt = cfg.motionseg.checkpoint
    if ckpt is None and DEFAULT_SEG_CKPT.exists():
        ckpt = str(DEFAULT_SEG_CKPT)
    if ckpt is None:
        return None
    mesh = _as_mesh(device)
    return _memo(("seg", _ckpt_key(ckpt), tuple(cfg.motionseg.resolution), mesh.key()),
                 lambda: _build_seg_apply(ckpt, tuple(cfg.motionseg.resolution), mesh))


def _build_seg_apply(ckpt, input_hw: tuple, mesh: Mesh):
    from ..io.checkpoint import load_msgpack, motionseg_state_dict_from_jax
    from ..models.depth import resize_bilinear
    from ..models.motionseg import TrajOADepth

    sidecar_threshold = None
    meta_path = Path(str(ckpt) + ".json")
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        input_hw = tuple(meta["input_hw"])
        sidecar_threshold = meta.get("threshold")
    blob = load_msgpack(ckpt)
    sd = motionseg_state_dict_from_jax(blob["params"], blob.get("batch_stats", {}))
    models = {}
    for d in mesh.distinct():
        model = TrajOADepth(input_hw=input_hw)
        model.load_state_dict(sd, strict=True)
        models[d] = model.to(d).eval()

    @torch.inference_mode()
    def apply(traj, depth, valid):
        depth = torch.as_tensor(depth)
        dev = depth.device if depth.device in models else mesh.flat[0]
        traj = np.asarray(traj)
        t = torch.from_numpy(traj.astype(np.float32)).to(dev)
        if traj.dtype == np.uint16:
            t = t * (1.0 / 65535.0)
        depth = resize_bilinear(depth.to(dev, torch.float32), input_hw)
        return models[dev](t, depth, torch.from_numpy(np.asarray(valid)).to(dev))

    apply.accepts_u16 = True
    apply.threshold = sidecar_threshold
    return apply


def run_pipeline(image_dir, output_dir, cfg: Config, log=print, device="cuda"):
    """Run the staged pipeline on one sequence; returns the Reconstruction
    (or, with --skip_sfm, the TrackArrays, labeled unless the scene is
    taken as static).

    The flow, depth and motion-seg applies run data-parallel over a mesh:
    every visible card for device="cuda", the one device for "cpu" or
    "cuda:k". The other stages run on the mesh's entry 0."""
    dev = resolve_device(device)
    mesh = mesh_for(dev)
    dev = mesh.flat[0]
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    timer = StageTimer(report_path=out / "timings.txt")
    save_config(cfg, out / "config.json")
    images, names = load_image_stack(image_dir)
    T, H, W = images.shape[:3]
    log(f"[pipeline] {T} frames at {W}x{H} from {image_dir} on {dev}"
        + (f" (mesh of {mesh.size}: {', '.join(mesh.key())})" if mesh.size > 1 else ""))

    raft_apply = _load_raft_apply(cfg, mesh)
    stack_box = [None]

    def device_stack():
        # lazy: a --skip_exists re-run that reuses every flow dir skips the upload
        if stack_box[0] is None:
            with timer.stage("frame_upload"):
                stack_box[0] = stages.upload_frame_stack(images, dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        return stack_box[0]

    with timer.stage("flow"):
        flows = stages.flow_stage(images, out, cfg, dev, raft_apply,
                                  device_stack=device_stack, log=log)
    with timer.stage("trajectories"):
        tracks = stages.tracking_stage(flows, H, W, out, cfg, device=dev, log=log)

    # motion segmentation (skipped with --assume_static); a missing depth
    # source degrades to assume-static, as in the reference
    if not cfg.assume_static:
        seg_apply = _load_seg_apply(cfg, mesh)
        if seg_apply is None:
            log("[pipeline] no segmentation checkpoint; treating scene as static")
        else:
            try:
                with timer.stage("depth"):
                    depths = stages.depth_stage(images, out, cfg, _load_depth_apply(cfg, mesh),
                                                device_stack=device_stack, log=log)
            except stages.MissingDepthError as e:
                log(f"[pipeline] WARNING: {e}; degrading to assume-static")
                depths = None
            if depths is not None:
                with timer.stage("motion_seg"):
                    tracks = stages.motionseg_stage(tracks, depths, (H, W), out, cfg,
                                                    seg_apply, mesh=mesh, log=log)

    # stage 4: global SfM
    result = tracks
    if not cfg.skip_sfm:
        with timer.stage("sfm"):
            result = stages.sfm_stage(tracks, H, W, out, cfg, dev, names, log=log)

    # intermediate cleanup (upstream run_particlesfm.py:44-45,66-70 semantics)
    if not cfg.keep_intermediate:
        for sub in ("optical_flows", "depth"):
            d = out / sub
            if d.is_dir():
                shutil.rmtree(d)
                log(f"[pipeline] removed intermediate {sub}/")
    log(timer.report())
    (out / "timings.txt").write_text(timer.report() + "\n")
    return result


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)
    jobs = []
    if args.root_dir:  # loop over sequences (upstream run_particlesfm.py:168-176)
        for seq in sorted(Path(args.root_dir).iterdir()):
            img = seq / args.image_folder
            if img.is_dir():
                jobs.append((img, seq / "particlesfm_tpu"))
    elif args.workspace_dir:
        ws = Path(args.workspace_dir)
        jobs.append((ws / args.image_folder, ws / "particlesfm_tpu"))
    elif args.image_dir and args.output_dir:
        jobs.append((Path(args.image_dir), Path(args.output_dir)))
    else:
        print("need --image_dir+--output_dir, --workspace_dir, or --root_dir",
              file=sys.stderr)
        return 2
    for img_dir, out_dir in jobs:
        run_pipeline(img_dir, out_dir, cfg, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
