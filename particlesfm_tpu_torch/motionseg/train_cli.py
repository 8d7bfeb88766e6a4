"""Motion-seg training CLI (port of particlesfm_tpu/motionseg/train_cli.py).

The reference's recipe (AdamW 1e-4/1e-4, class-balanced BCE, per-epoch IoU
eval, a checkpoint per epoch with the IoU in its name) with the host batcher
of data.py. `--synthetic` trains on generated batches and `--synthetic3d` on
procedural 3D scenes, so the loop runs without the FlyingThings3D download.
Checkpoints are flax msgpack {"params", "batch_stats", "step"}, which either
package loads; `--resume` takes the weights and the step and starts a fresh
optimizer, as the reference does.

Usage:
    python -m particlesfm_tpu_torch.motionseg.train_cli --data_root PREPARED_FT3D \
        --out_dir runs/seg [--epochs 50] [--device cpu]
    python -m particlesfm_tpu_torch.motionseg.train_cli --synthetic --out_dir runs/smoke
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", type=str, default=None)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic3d", action="store_true",
                    help="procedural 3D scenes with true parallax (synth3d.py)")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--steps_per_epoch", type=int, default=50)  # synthetic mode
    ap.add_argument("--pad_tracks", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--resolution", type=int, nargs=2, default=[272, 480])
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..io.checkpoint import (load_msgpack, motionseg_state_dict_from_jax,
                                 motionseg_variables_from_torch, msgpack_serialize)
    from ..models.motionseg import TrajOADepth
    from .data import FlyingThingsSeqDataset, synthetic_motion_batch
    from .train import create_train_state, eval_step, train_step

    dev = resolve_device(args.device)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    h, w = args.resolution

    if args.synthetic3d:
        from .synth3d import synth3d_batch

        dh, dw = h // 8, w // 8

        def epoch_batches():
            for _ in range(args.steps_per_epoch):
                yield synth3d_batch(rng, B=args.batch_size, depth_hw=(dh, dw))
        sample = synth3d_batch(rng, B=args.batch_size, depth_hw=(dh, dw))
        model = TrajOADepth(input_hw=(dh, dw))
    elif args.synthetic:
        def epoch_batches():
            for _ in range(args.steps_per_epoch):
                yield synthetic_motion_batch(rng, B=args.batch_size, H=h // 8, W=w // 8)
        sample = synthetic_motion_batch(rng, B=args.batch_size, H=h // 8, W=w // 8)
        model = TrajOADepth(input_hw=(h // 8, w // 8))
    else:
        ds = FlyingThingsSeqDataset(args.data_root, resolution=(h, w), seed=args.seed)

        def epoch_batches():
            return ds.batches(args.batch_size, args.pad_tracks)
        sample = next(iter(ds.batches(args.batch_size, args.pad_tracks)))
        model = TrajOADepth(input_hw=(h, w))

    state, tx = create_train_state(model.to(dev), args.seed, sample, args.lr,
                                   args.weight_decay)
    if args.resume:
        blob = load_msgpack(args.resume)
        sd = motionseg_state_dict_from_jax(blob["params"], blob["batch_stats"])
        model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
        state = state._replace(step=int(blob.get("step", 0)))
        print(f"resumed from {args.resume}")

    metrics_path = out / "test_metrics.txt"
    best_iou = -1.0
    for epoch in range(args.epochs):
        losses, ious = [], []
        for batch in epoch_batches():
            state, m = train_step(model, tx, state, batch)
            losses.append(float(m["loss"]))
            ious.append(float(m["iou"]))
        ev = eval_step(model, state, batch)
        line = (
            f"epoch {epoch}: train loss {np.mean(losses):.4f} iou {np.mean(ious):.4f} "
            f"| eval loss {float(ev['loss']):.4f} iou {float(ev['iou']):.4f}"
        )
        print(line, flush=True)
        with open(metrics_path, "a") as f:
            f.write(line + "\n")
        iou = float(ev["iou"])
        blob = msgpack_serialize({**motionseg_variables_from_torch(model.state_dict()),
                                  "step": int(state.step)})
        # the reference's save_model: the IoU in the file name
        (out / f"checkpoint_e{epoch}_iou{iou:.3f}.msgpack").write_bytes(blob)
        if iou > best_iou:
            best_iou = iou
            (out / "checkpoint_best.msgpack").write_bytes(blob)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
