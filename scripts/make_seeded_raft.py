"""Write the seeded raft-things checkpoint that the benchmark's `raft_things`
configuration runs: RAFT at the published raft-things widths (Teed & Deng
2020; hidden 128, context 128, feature encoder 256 from base 64, batch-norm
context encoder), its weights drawn from a seed, since the released
`raft-things.pth` is not in the repository.

- `RAFT()` is built under `torch.manual_seed(SEED)` with torch's default
  initialisation.
- The context encoder's batch-norm statistics are drawn from a
  `torch.Generator` seeded the same, in module order: running mean
  N(0, 0.1^2), running variance U(0.5, 2.0), so the eval-mode batch norm is
  not the identity.
- `update_block.flow_head.conv2`'s weight and bias are scaled by
  `HEAD_SCALE`. Unscaled, that layer's seeded bias alone moves the flow
  by up to 0.02 of a 1/8-resolution pixel per GRU iteration, ~3 px after
  20, in the same direction forward and backward, so the tracker's
  forward-backward check keeps almost no trajectory; scaled by 0.1, the
  net's flow stays inside the refinement's 3 px trust region. It changes
  no arithmetic and no cost.
- Every value is rounded to float16 and stored as float16 (10.5 MB, where
  float32 would take 21 MB of the repository); the loaders widen it to
  float32 exactly, so the net computes in float32 as the configuration
  states.

It runs on the CPU and writes the same bytes on every run:

    python scripts/make_seeded_raft.py [--out checkpoints/raft_things_seed0.msgpack]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
import torch.nn as nn

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from particlesfm_tpu_torch.flow.infer import save_flow_checkpoint  # noqa: E402
from particlesfm_tpu_torch.models.raft import RAFT  # noqa: E402

SEED = 0
HEAD_SCALE = 0.1
ITERS = 20


def seeded_things_raft() -> RAFT:
    """The float32 raft-things RAFT of `SEED`, before its rounding to float16."""
    torch.manual_seed(SEED)
    model = RAFT()
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
        model.update_block.flow_head.conv2.weight.mul_(HEAD_SCALE)
        model.update_block.flow_head.conv2.bias.mul_(HEAD_SCALE)
    return model.eval()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "checkpoints" / "raft_things_seed0.msgpack"))
    args = ap.parse_args(argv)
    model = seeded_things_raft().half()
    save_flow_checkpoint(args.out, model, "things", {
        "iters": ITERS, "seed": SEED, "head_scale": HEAD_SCALE,
        "weights": "seeded: torch default init under torch.manual_seed(seed); batch-norm "
                   "running mean N(0, 0.1^2), running var U(0.5, 2.0); flow_head.conv2 "
                   "weight and bias times head_scale; stored as float16, run in float32"})
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
