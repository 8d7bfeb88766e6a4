"""Sintel pose-evaluation CLI — parity with upstream evaluation_evo/eval_sintel.py.

Usage:
    python -m particlesfm_tpu_torch.eval.sintel --gt_root SINTEL/training/camdata_left \
        --pred_root OUT_ROOT [--seqs alley_2 ambush_4 ...]

Layout expectations (matching the reference's):
  gt_root/<seq>/frame_%04d.cam            Sintel GT camera files
  pred_root/<seq>/particlesfm_tpu/colmap_outputs_converted/poses/*.txt
Writes errors_ate.txt next to pred_root (eval_sintel.py:139-170). A copy of
particlesfm_tpu/eval/sintel.py; the default --pred_subdir is where either
package's --root_dir run writes its poses.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from .pose_eval import evaluate_sequence, load_pose_dir, read_sintel_cam, summarize

# the 13/14-sequence split used in the reference README tables
DEFAULT_SEQS = [
    "alley_2", "ambush_4", "ambush_5", "ambush_6", "cave_2", "cave_4",
    "market_2", "market_5", "market_6", "shaman_3", "sleeping_1",
    "sleeping_2", "temple_2", "temple_3",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--pred_root", required=True)
    ap.add_argument("--pred_subdir", default="particlesfm_tpu/colmap_outputs_converted/poses")
    ap.add_argument("--seqs", nargs="*", default=DEFAULT_SEQS)
    ap.add_argument("--plot_dir", default=None)
    args = ap.parse_args(argv)

    results = []
    for seq in args.seqs:
        gt_dir = Path(args.gt_root) / seq
        if not gt_dir.is_dir():
            continue
        gt = {}
        for cam in sorted(gt_dir.glob("*.cam")):
            _, w2c = read_sintel_cam(cam)
            gt[cam.stem] = w2c
        pred_dir = Path(args.pred_root) / seq / args.pred_subdir
        est = load_pose_dir(pred_dir) if pred_dir.is_dir() else {}
        results.append(evaluate_sequence(est, gt, name=seq))
        if args.plot_dir:
            from .plots import plot_trajectories

            Path(args.plot_dir).mkdir(parents=True, exist_ok=True)
            plot_trajectories(est, gt, Path(args.plot_dir) / f"{seq}.png", seq)
    report = summarize(results)
    print(report)
    out = Path(args.pred_root) / "errors_ate.txt"
    out.write_text(report + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
