"""Compact-RAFT trainer on synth renders (port of particlesfm_tpu/flow/train.py).

The RAFT recipe of the reference: sequence loss sum_i gamma^(N-i)
||f_i - gt||_1 over the GRU iterations, AdamW with a one-cycle rate (a
constant under 50 steps), gradients clipped to a global norm of 1. The net
trains through `models.raft.lookup_corr_hat`, the reference's XLA lookup
(its trainer builds `compact_raft(remat=True)` with `use_pallas=False`), each
GRU iteration recomputed in the backward pass. Validation runs the inference
model, whose lookup is kernel K1 on CUDA.

The random streams are the reference's: a numpy generator per step seeded
`seed * 1000003 + step` draws the batch's pair indices, then its crop
offsets. The dataset lives on the device (u8 frames, f16 flows) and batches
are gathered there. The reference's 10-step `lax.scan` per dispatch is a
device-dispatch workaround; here each step is dispatched on its own and its
loss recorded. Resume files have the reference's layout (`params`,
`opt_state` in optax's state-dict form, `step`, `best_epe`): either package
continues the other's.

Usage:
    python -m particlesfm_tpu_torch.flow.train --out runs/raft_port.msgpack \
        --scenes 120 --steps 6000 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..io.checkpoint import (conv_bn_arrays_from_jax, conv_bn_variables_from_torch,
                             load_msgpack, raft_state_dict_from_jax, save_msgpack)
from ..utils import optim


def sequence_loss(flows_pred: torch.Tensor, flow_gt: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = 400.0) -> torch.Tensor:
    """flows_pred [iters, B, H, W, 2], flow_gt [B, H, W, 2]: the weighted sum
    over iterations of each one's mean L1 error, pixels with |gt| >= max_flow
    counted as zero."""
    mag = torch.linalg.vector_norm(flow_gt, dim=-1)
    valid = (mag < max_flow).to(flows_pred.dtype)[None, ..., None]
    n = flows_pred.shape[0]
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=flows_pred.dtype,
                                    device=flows_pred.device)
    per_iter = ((flows_pred - flow_gt[None]).abs() * valid).mean(dim=(1, 2, 3, 4))
    return (weights * per_iter).sum()


def epe(flow_pred, flow_gt) -> float:
    """Mean end-point error (numpy or tensors)."""
    if torch.is_tensor(flow_pred):
        flow_pred = flow_pred.detach().cpu().numpy()
    return float(np.mean(np.linalg.norm(np.asarray(flow_pred) - flow_gt, axis=-1)))


def save_resume_state(path, params: dict, opt_state: dict, step: int, best_epe: float) -> None:
    """The reference's resume file: {"params", "opt_state", "step", "best_epe"}
    with flax trees for params and optax's state-dict form for opt_state."""
    save_msgpack(path, {"params": params, "opt_state": opt_state, "step": int(step),
                        "best_epe": float(best_epe)})


def load_resume_state(path):
    """-> (params tree, opt_state tree, step, best_epe)."""
    blob = load_msgpack(path)
    return blob["params"], blob["opt_state"], int(blob["step"]), float(blob["best_epe"])


def _names(model) -> list:
    return [n for n, _ in model.named_parameters()]


def _tree(arrays: dict) -> dict:
    """{parameter name: array} -> the flax params tree."""
    return conv_bn_variables_from_torch(arrays)[0]


def model_state(model, opt, schedule: bool) -> tuple:
    """(params tree, opt_state tree) of a conv net (RAFT, DepthNet) and its
    clip -> adamw chain, as the reference's resume file holds them."""
    return (_tree(model.state_dict()),
            optim.adamw_state_dict(opt, _names(model), _tree, schedule))


def load_model_state(model, opt, params: dict, opt_state: dict, batch_stats=None) -> int:
    """Load a resume file's trees into the model and the optimizer."""
    dev = next(model.parameters()).device
    sd = raft_state_dict_from_jax(params, batch_stats)
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return optim.load_adamw_state_dict(opt, _names(model), opt_state,
                                       conv_bn_arrays_from_jax)


def build_model(seed: int, init_ckpt=None, device="cuda", log=print):
    """compact RAFT (remat) with flax's initial values drawn from
    torch.Generator(seed), or warm-started from `init_ckpt`; training lookup."""
    from ..models.raft import compact_raft, lookup_corr_hat
    from .infer import load_flow_checkpoint

    model = compact_raft(remat=True)
    optim.flax_init_(model, torch.Generator().manual_seed(seed))
    if init_ckpt and Path(init_ckpt).exists():
        params, _, _ = load_flow_checkpoint(init_ckpt)
        model.load_state_dict(raft_state_dict_from_jax(params), strict=True)
        log(f"[flowtrain] warm-started params from {init_ckpt}")
    model.lookup = lookup_corr_hat
    return model.to(device).train()


def gather_batch(d1, d2, dfl, idx: torch.Tensor, offs: torch.Tensor, crop_hw):
    """Crops [B, ch, cw, C] of the device-resident dataset at pair indices
    idx [B] and top-left offsets offs [B, 2] (y, x), as float32."""
    ch, cw = crop_hw
    ys = offs[:, 0, None] + torch.arange(ch, device=idx.device)
    xs = offs[:, 1, None] + torch.arange(cw, device=idx.device)
    ii, yy, xx = idx[:, None, None], ys[:, :, None], xs[:, None, :]
    return tuple(d[ii, yy, xx].to(torch.float32) for d in (d1, d2, dfl))


def step_draws(seed: int, it: int, n: int, batch: int, H: int, W: int, ch: int, cw: int):
    """The reference's per-step draws: pair indices, then crop offsets (y, x)."""
    r = np.random.default_rng(seed * 1000003 + it)
    idx = r.integers(0, n, batch)
    offs = np.stack([r.integers(0, H - ch + 1, batch), r.integers(0, W - cw + 1, batch)], -1)
    return idx, offs


def loss_and_grads(model, b1, b2, bf, iters: int, use_tf32: bool = True):
    """The sequence loss of one batch and the parameters' gradients (left in
    .grad); TF32 as the reference's default matmul precision, unless off."""
    model.zero_grad(set_to_none=True)
    with optim.tf32(use_tf32):
        preds = model(b1, b2, iters=iters, all_iters=True)      # [B, iters, H, W, 2]
        loss = sequence_loss(preds.transpose(0, 1), bf)
        loss.backward()
    return loss.detach()


def train_step(model, opt, b1, b2, bf, iters: int, lr: float, use_tf32: bool = True):
    """One clip(1.0) -> adamw update; returns the loss."""
    loss = loss_and_grads(model, b1, b2, bf, iters, use_tf32)
    optim.clip_by_global_norm([p.grad for p in model.parameters()], 1.0)
    opt.set_lr(lr)
    opt.step()
    return loss


@torch.no_grad()
def infer(model, a, b, iters: int):
    """Inference flows of image batches [B, H, W, 3] with the model's
    inference lookup (K1 on CUDA, the plain version on the CPU)."""
    from ..ops.corr_lookup import lookup_corr

    lookup, model.lookup = model.lookup, lookup_corr
    model.eval()
    try:
        with optim.tf32(True):
            return model(a, b, iters=iters)
    finally:
        model.lookup = lookup
        model.train()


def train(
    out_path,
    num_scenes: int = 120,
    steps: int = 6000,
    batch: int = 4,
    iters: int = 12,
    lr: float = 2e-4,
    seed: int = 0,
    dataset_cache: str | None = None,
    workers: int = 4,
    eval_every: int = 500,
    resume: str | None = None,
    max_seconds: float = 0.0,
    save_every: int = 200,
    crop_hw: tuple | None = (192, 256),
    infer_iters: int = 12,
    init_ckpt: str | None = None,
    log=print,
    device="cuda",
    stats: dict | None = None,
):
    """Train and save the best-validation checkpoint to `out_path`; returns
    the best validation EPE. `stats`, when given, receives the per-step
    losses, the seconds of the step loop and the validation EPEs."""
    from .data import FlowPairSpec, generate_dataset, load_dataset, save_dataset
    from .infer import save_flow_checkpoint

    dev = resolve_device(device)
    t0 = time.time()
    if dataset_cache and Path(dataset_cache).exists():
        i1, i2, fl = load_dataset(dataset_cache)
        log(f"[flowtrain] loaded cached dataset: {len(i1)} pairs")
    else:
        i1, i2, fl = generate_dataset(num_scenes, FlowPairSpec(), seed=seed,
                                      workers=workers, log=log)
        if dataset_cache:
            save_dataset(dataset_cache, i1, i2, fl)
        log(f"[flowtrain] rendered {len(i1)} pairs in {time.time() - t0:.0f}s")
    # held-out split for EPE tracking
    n_val = min(max(8, len(i1) // 20), len(i1) // 2)
    val = (i1[:n_val], i2[:n_val], fl[:n_val].astype(np.float32))
    i1, i2, fl = i1[n_val:], i2[n_val:], fl[n_val:]

    model = build_model(seed, init_ckpt, dev, log)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[flowtrain] compact RAFT: {n_params / 1e6:.2f}M params")
    schedule = steps >= 50     # onecycle with < ~50 steps has zero-length phases
    sched = optim.linear_onecycle_schedule(steps, lr, pct_start=0.1) if schedule else None
    opt = optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-5)

    d1, d2, dfl = (torch.from_numpy(a).to(dev) for a in (i1, i2, fl))
    H, W = i1.shape[1:3]
    ch, cw = crop_hw if crop_hw else (H, W)
    ch, cw = min(ch, H), min(cw, W)

    best_epe = np.inf
    start_step = 0
    if resume and Path(resume).exists():
        params, opt_state, start_step, best_epe = load_resume_state(resume)
        load_model_state(model, opt, params, opt_state)
        log(f"[flowtrain] resumed from {resume} @ step {start_step} "
            f"(best EPE {best_epe:.3f})")

    def run_eval(it):
        nonlocal best_epe
        errs = []
        for k in range(0, len(val[0]), batch):
            a = torch.from_numpy(val[0][k:k + batch]).to(dev, torch.float32)
            b = torch.from_numpy(val[1][k:k + batch]).to(dev, torch.float32)
            errs.append(epe(infer(model, a, b, iters), val[2][k:k + batch]))
        cur = float(np.mean(errs))
        log(f"[flowtrain] step {it}: val EPE {cur:.3f} px")
        if stats is not None:
            stats.setdefault("val_epe", []).append(cur)
        if cur < best_epe:
            best_epe = cur
            save_flow_checkpoint(out_path, model, "compact",
                                 {"iters": infer_iters, "train_iters": iters, "val_epe": cur})
            log(f"[flowtrain] saved {out_path} (EPE {cur:.3f})")

    losses = []
    t0 = time.time()
    it = start_step
    while it < steps:
        idx, offs = step_draws(seed, it, len(i1), batch, H, W, ch, cw)
        b1, b2, bf = gather_batch(d1, d2, dfl, torch.from_numpy(idx).to(dev),
                                  torch.from_numpy(offs).to(dev), (ch, cw))
        rate = sched(it) if schedule else lr
        losses.append(train_step(model, opt, b1, b2, bf, iters, rate))
        it += 1
        if it % 10 == 0 or it == steps:
            recent = torch.stack(losses[-10:]).cpu().numpy()
            log(f"[flowtrain] step {it}/{steps} loss {recent.mean():.3f} "
                f"({(it - start_step) / (time.time() - t0):.2f} it/s)")
        if it % eval_every == 0 or it == steps:
            run_eval(it)
        hit_wall = max_seconds > 0 and time.time() - t0 > max_seconds
        if resume and (it % save_every == 0 or hit_wall or it == steps):
            save_resume_state(resume, *model_state(model, opt, schedule), it, best_epe)
        if hit_wall and it < steps:
            log(f"[flowtrain] wall budget hit at step {it}; resume state saved")
            break
    if stats is not None:
        stats["losses"] = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
        stats["seconds"] = time.time() - t0
    return best_epe


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenes", type=int, default=120)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset_cache", default=None)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--resume", default=None,
                    help="resume-state file; created/updated for chunked runs")
    ap.add_argument("--max_seconds", type=float, default=0.0,
                    help="stop (saving resume state) after this wall budget")
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--crop", type=int, nargs=2, default=(192, 256),
                    help="random-crop size for training steps (0 0 = full)")
    ap.add_argument("--infer_iters", type=int, default=12,
                    help="GRU iterations recorded in the checkpoint meta for inference")
    ap.add_argument("--init_ckpt", default=None,
                    help="warm-start params from an inference checkpoint")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    crop = tuple(args.crop) if args.crop and args.crop[0] > 0 else None
    best = train(args.out, args.scenes, args.steps, args.batch, args.iters,
                 args.lr, args.seed, args.dataset_cache, args.workers,
                 eval_every=args.eval_every, resume=args.resume,
                 max_seconds=args.max_seconds, crop_hw=crop,
                 infer_iters=args.infer_iters, init_ckpt=args.init_ckpt,
                 device=args.device)
    print(f"best val EPE: {best:.3f} px")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
