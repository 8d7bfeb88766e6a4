"""ScanNet pose-evaluation CLI — parity with upstream evaluation_evo/eval_scannet.py.

Usage:
    python -m particlesfm_tpu_torch.eval.scannet --gt_root SCANNET_POSES --pred_root OUT

Layout: gt_root/<scene>/pose/*.txt (4x4 cam2world per frame) matching frame
stems of pred_root/<scene>/particlesfm_tpu/colmap_outputs_converted/poses/*.txt.
A copy of particlesfm_tpu/eval/scannet.py.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from .pose_eval import evaluate_sequence, load_pose_dir, read_scannet_pose, summarize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--pred_root", required=True)
    ap.add_argument("--pred_subdir", default="particlesfm_tpu/colmap_outputs_converted/poses")
    ap.add_argument("--gt_subdir", default="pose")
    ap.add_argument("--seqs", nargs="*", default=None)
    ap.add_argument("--plot_dir", default=None)
    args = ap.parse_args(argv)

    seqs = args.seqs or sorted(
        p.name for p in Path(args.gt_root).iterdir() if p.is_dir()
    )
    results = []
    for seq in seqs:
        gt_dir = Path(args.gt_root) / seq / args.gt_subdir
        if not gt_dir.is_dir():
            continue
        gt = {p.stem: read_scannet_pose(p) for p in sorted(gt_dir.glob("*.txt"))}
        pred_dir = Path(args.pred_root) / seq / args.pred_subdir
        est = load_pose_dir(pred_dir) if pred_dir.is_dir() else {}
        results.append(evaluate_sequence(est, gt, name=seq))
        if args.plot_dir:
            from .plots import plot_trajectories

            Path(args.plot_dir).mkdir(parents=True, exist_ok=True)
            plot_trajectories(est, gt, Path(args.plot_dir) / f"{seq}.png", seq)
    report = summarize(results)
    print(report)
    (Path(args.pred_root) / "errors_ate.txt").write_text(report + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
