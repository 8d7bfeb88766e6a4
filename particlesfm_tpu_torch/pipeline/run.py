"""Pipeline orchestrator + CLI (port of particlesfm_tpu/pipeline/run.py).

Same three input modes (--image_dir+--output_dir, --workspace_dir with an
images subfolder, --root_dir looping over sequences), same stage toggles and
hyperparameter defaults, same config tree and `--set` overrides, same output
layout — so either package's stages can pick up the other's outputs. The
port runs the flow and trajectory stages; a config that asks for a stage it
does not have yet raises NotImplementedError. Runs on CUDA unless
`--device cpu` is given.

Usage:
    python -m particlesfm_tpu_torch.pipeline.run --image_dir IMG --output_dir OUT \\
        --assume_static --skip_sfm --set flow.selfcal=false
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import torch

from .. import resolve_device
from ..io.images import load_image_stack
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


DEFAULT_RAFT_CKPT = Path(__file__).resolve().parents[2] / "checkpoints" / "raft_synth.msgpack"


def _load_raft_apply(cfg: Config, device):
    """Pair-indexed flow apply with refinement fused after the net; defaults
    to the repo's compact checkpoint."""
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
    return load_flow_apply_pairs(
        ckpt, iters=cfg.flow.iters, per_device=cfg.flow.per_device,
        scale=cfg.flow.infer_scale, refine_schedule=schedule,
        refine_max_total=cfg.flow.refine_max_total_px, device=device,
    )


def run_pipeline(image_dir, output_dir, cfg: Config, log=print, device="cuda"):
    """Run the ported stages on one sequence; returns the TrackArrays."""
    stages.require_ported(cfg)
    dev = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    timer = StageTimer(report_path=out / "timings.txt")
    save_config(cfg, out / "config.json")
    images, _ = load_image_stack(image_dir)
    T, H, W = images.shape[:3]
    log(f"[pipeline] {T} frames at {W}x{H} from {image_dir} on {dev}")

    raft_apply = _load_raft_apply(cfg, dev)
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
        flows = stages.flow_stage(images, out, cfg, raft_apply,
                                  device_stack=device_stack, log=log)
    with timer.stage("trajectories"):
        tracks = stages.tracking_stage(flows, H, W, out, cfg, device=dev, log=log)

    # intermediate cleanup (upstream run_particlesfm.py:44-45 semantics)
    if not cfg.keep_intermediate:
        d = out / "optical_flows"
        if d.is_dir():
            shutil.rmtree(d)
            log("[pipeline] removed intermediate optical_flows/")
    log(timer.report())
    (out / "timings.txt").write_text(timer.report() + "\n")
    return tracks


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
