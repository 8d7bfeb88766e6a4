"""Motion-segmentation trainer: AdamW + class-balanced BCE + IoU eval (port
of particlesfm_tpu/motionseg/train.py).

The recipe of the reference's single-GPU loop (motion_seg/train_seq.py):
AdamW(lr 1e-4, weight decay 1e-4) with no clip and no schedule,
class-balanced BCE with positive weight #neg/#pos, per-batch cls_iou. The
batch norms train as flax's (`models.motionseg._BatchNorm`), at the
reference's full float32 precision (no TF32). A train state holds the model,
its optimizer and the step count; `train_step` and `eval_step` take numpy or
tensor batches of traj [B, N, L, 2], depth [B, L, h, w], valid [B, N, L],
label [B, N] and traj_valid [B, N].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.motionseg import TrajOADepth
from ..utils import optim


class TrainState(NamedTuple):
    model: Any
    opt: Any
    step: int


def create_train_state(model: TrajOADepth, key, sample_batch=None,
                       learning_rate: float = 1e-4, weight_decay: float = 1e-4):
    """flax's initial values drawn from `key` (an int seed or a
    torch.Generator) and a fresh AdamW; returns (state, optimizer).
    `sample_batch` is accepted for the reference's signature (flax infers
    shapes from it; the torch modules know theirs)."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    dev = next(model.parameters()).device
    optim.flax_init_(model.cpu(), gen)
    model.to(dev).train()
    opt = optim.AdamW(model.parameters(), lr=learning_rate, weight_decay=weight_decay)
    return TrainState(model=model, opt=opt, step=0), opt


def weighted_bce(logits, targets, valid):
    """Class-balanced BCE: positive examples weighted by #neg/#pos.
    logits/targets/valid: [B, N]."""
    v = valid.to(logits.dtype)
    pos = (targets * v).sum()
    neg = ((1.0 - targets) * v).sum()
    pos_w = neg / torch.clamp(pos, min=1.0)
    w = torch.where(targets > 0.5, pos_w, torch.ones_like(pos_w)) * v
    per = optim.sigmoid_binary_cross_entropy(logits, targets)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def cls_iou(logits, targets, valid, threshold: float = 0.5):
    """Per-batch IoU of the predicted dynamic trajectories."""
    pred = (torch.sigmoid(logits) > threshold) & valid
    gt = (targets > 0.5) & valid
    inter = (pred & gt).sum().to(torch.float32)
    union = (pred | gt).sum().to(torch.float32)
    return inter / torch.clamp(union, min=1.0)


def _batch(batch, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(model, batch):
    """The weighted BCE of a batch with gradients left in .grad; the
    logits come back beside it."""
    b = _batch(batch, next(model.parameters()).device)
    model.zero_grad(set_to_none=True)
    logits = model(b["traj"], b["depth"], b["valid"])
    loss = weighted_bce(logits, b["label"], b["traj_valid"])
    loss.backward()
    return loss.detach(), logits.detach(), b


def train_step(model: TrajOADepth, tx, state: TrainState, batch):
    """One adamw update on `batch`; returns (new state, {"loss", "iou"})."""
    model.train()
    loss, logits, b = loss_and_grads(model, batch)
    tx.step()
    iou = cls_iou(logits, b["label"], b["traj_valid"])
    return state._replace(step=state.step + 1), {"loss": loss, "iou": iou}


@torch.no_grad()
def eval_step(model: TrajOADepth, state: TrainState, batch):
    """Loss and IoU of `batch` with the running statistics."""
    b = _batch(batch, next(model.parameters()).device)
    model.eval()
    try:
        logits = model(b["traj"], b["depth"], b["valid"])
    finally:
        model.train()
    return {"loss": weighted_bce(logits, b["label"], b["traj_valid"]),
            "iou": cls_iou(logits, b["label"], b["traj_valid"])}
