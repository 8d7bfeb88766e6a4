"""DepthNet trainer on synth renders (port of particlesfm_tpu/depth/train.py).

Trains the MiDaS-contract depth net (image -> relative inverse depth) on the
textured ray-cast world the flow net trains on, with the scale-shift-
invariant loss. As in the reference, each image goes through the net on its
own (its batch norms take that image's statistics; `models.depth.
PerImageBatchNorm2d`) and the running statistics move by the batch mean of
the images' updates; AdamW with a one-cycle rate (a constant under 50 steps)
after clipping to a global norm of 1. The per-step pair indices come from a
numpy generator seeded `seed * 900001 + step`; the dataset lives on the
device. Checkpoints are flax msgpack {"params", "batch_stats"} with a `.json`
sidecar; resume files have the reference's layout, params {"p", "bs"}.

Usage:
    python -m particlesfm_tpu_torch.depth.train --out runs/depth_port.msgpack [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..flow.train import load_model_state, load_resume_state, model_state, save_resume_state
from ..io.checkpoint import depth_variables_from_torch, save_msgpack
from ..utils import optim


def _gen_scene_frames(args):
    seed, hw, frames = args
    from ..synth import random_scene

    rng = np.random.default_rng(seed)
    h, w = hw
    sc = random_scene(
        rng, num_views=frames, height=h, width=w,
        focal=1.2 * w * rng.uniform(0.8, 1.3),
        num_dynamic=int(rng.integers(0, 3)),
        motion_scale=float(rng.uniform(0.2, 0.6)),
        rot_scale=float(rng.uniform(0.3, 1.0)),
        num_static_obj=int(rng.integers(2, 8)),
    )
    out = []
    for t in range(frames):
        out.append((sc.render(t), sc.gt_inverse_depth_norm(t).astype(np.float16)))
    return out


def generate_depth_dataset(num_scenes: int, hw=(256, 320), frames: int = 3,
                           seed: int = 0, workers: int = 4, log=print):
    """(images [N, h, w, 3] u8, normalized inverse depths [N, h, w] f16)."""
    jobs = [(seed * 77003 + i, hw, frames) for i in range(num_scenes)]
    out = []
    if workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            for i, fr in enumerate(pool.imap_unordered(_gen_scene_frames, jobs)):
                out.extend(fr)
                if (i + 1) % 20 == 0:
                    log(f"[depthdata] {i+1}/{num_scenes} scenes")
    else:
        for job in jobs:
            out.extend(_gen_scene_frames(job))
    imgs = np.stack([o[0] for o in out])
    deps = np.stack([o[1] for o in out])
    return imgs, deps


def build_model(seed: int, device="cuda"):
    """DepthNet with flax's initial values drawn from torch.Generator(seed)."""
    from ..models.depth import DepthNet

    model = optim.flax_init_(DepthNet(), torch.Generator().manual_seed(seed))
    return model.to(device).train()


def loss_and_grads(model, bi: torch.Tensor, bd: torch.Tensor, use_tf32: bool = True):
    """Mean SSI loss of a batch (images [B, H, W, 3] in [0, 255], targets
    [B, H, W]) with gradients left in .grad; the batch norms' running
    statistics move once."""
    from ..models.depth import scale_shift_invariant_loss

    model.zero_grad(set_to_none=True)
    with optim.tf32(use_tf32):
        # NCHW-contiguous: on channels-last strides torch's CPU (oneDNN)
        # convolution backward corrupted memory with 4 or more threads
        pred = model(bi.permute(0, 3, 1, 2).contiguous())
        loss = scale_shift_invariant_loss(pred, bd, torch.ones_like(bd)).mean()
        loss.backward()
    return loss.detach()


def train_step(model, opt, bi, bd, lr: float, use_tf32: bool = True):
    """One clip(1.0) -> adamw update; returns the loss."""
    loss = loss_and_grads(model, bi, bd, use_tf32)
    optim.clip_by_global_norm([p.grad for p in model.parameters()], 1.0)
    opt.set_lr(lr)
    opt.step()
    return loss


def variables(model) -> dict:
    """{"params", "batch_stats"} flax trees of the model."""
    return depth_variables_from_torch(model.state_dict())


@torch.no_grad()
def infer(model, bi: torch.Tensor) -> torch.Tensor:
    """Eval-mode depth [B, H, W] of images [B, H, W, 3]."""
    model.eval()
    try:
        with optim.tf32(True):
            return model(bi.permute(0, 3, 1, 2).contiguous())
    finally:
        model.train()


def train(
    out_path,
    num_scenes: int = 150,
    steps: int = 3000,
    batch: int = 8,
    lr: float = 2e-4,
    seed: int = 0,
    dataset_cache: str | None = None,
    workers: int = 4,
    eval_every: int = 500,
    resume: str | None = None,
    max_seconds: float = 0.0,
    save_every: int = 500,
    log=print,
    device="cuda",
    stats: dict | None = None,
):
    """Train and save the best-validation checkpoint to `out_path`; returns
    the best validation SSI-MSE. `stats`, when given, receives the per-step
    losses and the seconds of the step loop."""
    dev = resolve_device(device)
    t0 = time.time()
    if dataset_cache and Path(dataset_cache).exists():
        z = np.load(dataset_cache)
        imgs, deps = z["images"], z["depths"]
        log(f"[depthtrain] loaded cached dataset: {len(imgs)} frames")
    else:
        imgs, deps = generate_depth_dataset(num_scenes, seed=seed, workers=workers, log=log)
        if dataset_cache:
            np.savez_compressed(dataset_cache, images=imgs, depths=deps)
        log(f"[depthtrain] rendered {len(imgs)} frames in {time.time()-t0:.0f}s")
    n_val = min(max(8, len(imgs) // 20), len(imgs) // 2)
    val = (imgs[:n_val], deps[:n_val].astype(np.float32))
    imgs, deps = imgs[n_val:], deps[n_val:]

    model = build_model(seed, dev)
    schedule = steps >= 50     # onecycle with < ~50 steps has zero-length phases
    sched = optim.linear_onecycle_schedule(steps, lr, pct_start=0.1) if schedule else None
    opt = optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-5)
    dimgs, ddeps = torch.from_numpy(imgs).to(dev), torch.from_numpy(deps).to(dev)

    def val_ssi():
        errs = []
        for k in range(0, len(val[0]), batch):
            pred = infer(model, torch.from_numpy(val[0][k:k + batch]).to(dev, torch.float32))
            pred = pred.cpu().numpy()
            for j in range(len(pred)):
                t = val[1][k + j].ravel()
                pr = np.nan_to_num(pred[j].ravel(), posinf=1e6, neginf=-1e6)
                # closed-form scale/shift alignment (regularized normal equations)
                var = pr.var() + 1e-8
                s = ((pr - pr.mean()) * (t - t.mean())).mean() / var
                b = t.mean() - s * pr.mean()
                errs.append(float(np.mean((s * pr + b - t) ** 2)))
        return float(np.mean(errs))

    best = np.inf
    start_step = 0
    if resume and Path(resume).exists():
        state, opt_state, start_step, best = load_resume_state(resume)
        load_model_state(model, opt, state["p"], opt_state, state["bs"])
        log(f"[depthtrain] resumed from {resume} @ step {start_step} "
            f"(best SSI {best:.5f})")

    def save_best(it, cur):
        save_msgpack(out_path, variables(model))
        Path(str(out_path) + ".json").write_text(json.dumps({"val_ssi_mse": cur, "step": it}))
        log(f"[depthtrain] saved {out_path}")

    losses = []
    t0 = time.time()
    it = start_step
    while it < steps:
        # per-step rng keyed on the step index: identical stream across resumes
        idx = np.random.default_rng(seed * 900001 + it).integers(0, len(imgs), batch)
        idx = torch.from_numpy(idx).to(dev)
        rate = sched(it) if schedule else lr
        losses.append(train_step(model, opt, dimgs[idx].to(torch.float32),
                                 ddeps[idx].to(torch.float32), rate))
        it += 1
        if it % 50 == 0 or it == steps:
            recent = torch.stack(losses[-50:]).cpu().numpy()
            log(f"[depthtrain] step {it}/{steps} loss {recent.mean():.5f} "
                f"({(it - start_step) / (time.time() - t0):.1f} it/s)")
        if it % eval_every == 0 or it == steps:
            cur = val_ssi()
            log(f"[depthtrain] step {it}: val SSI-MSE {cur:.5f}")
            if cur < best:
                best = cur
                save_best(it, cur)
        hit_wall = max_seconds > 0 and time.time() - t0 > max_seconds
        if resume and (it % save_every == 0 or hit_wall or it == steps):
            v = variables(model)
            save_resume_state(resume, {"p": v["params"], "bs": v["batch_stats"]},
                              model_state(model, opt, schedule)[1], it, best)
        if hit_wall and it < steps:
            log(f"[depthtrain] wall budget hit at step {it}; resume state saved")
            break
    if stats is not None:
        stats["losses"] = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
        stats["seconds"] = time.time() - t0
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenes", type=int, default=150)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset_cache", default=None)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--resume", default=None,
                    help="resume-state file; created/updated for chunked runs")
    ap.add_argument("--max_seconds", type=float, default=0.0,
                    help="stop (saving resume state) after this wall budget")
    ap.add_argument("--eval_every", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    best = train(args.out, args.scenes, args.steps, args.batch, args.lr,
                 args.seed, args.dataset_cache, args.workers,
                 eval_every=args.eval_every, resume=args.resume,
                 max_seconds=args.max_seconds, device=args.device)
    print(f"best val SSI-MSE: {best:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
