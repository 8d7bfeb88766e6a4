"""The optax pieces the trainers use, written out for torch (port-only module).

The JAX trainers chain `optax.clip_by_global_norm` and `optax.adamw`, with
`optax.linear_onecycle_schedule` for the flow and depth nets
(particlesfm_tpu/flow/train.py:121-129, depth/train.py:100-103), and take the
motion-seg loss from `optax.sigmoid_binary_cross_entropy`
(motionseg/train.py:64). Each function here computes what its optax namesake
computes, in the same order of operations, so one step of a port trainer
holds against the JAX trainer's step:
- `clip_by_global_norm` scales by `max_norm / norm` only when the norm
  reaches `max_norm`, and divides before it multiplies
  (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm);
- `AdamW` is `torch.optim.AdamW`, the same update as optax's adamw
  (decoupled decay, the same bias correction); the trainer sets its `lr`
  before every step from `linear_onecycle_schedule`, evaluated at the count
  of updates taken so far, as optax's `scale_by_schedule` does;
- `adamw_state_dict` / `load_adamw_state_dict` carry the optimizer state to
  and from optax's `to_state_dict` form of the chains, so a resume file
  written by either package continues in the other.

Two training helpers sit beside them: `flax_init_` gives a model flax's
initial values (it cannot replay `jax.random`, so parity tests carry JAX's
initial parameters over instead), and `tf32` scopes the TF32 policy that
stands in for `jax.default_matmul_precision("default")`.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squared entries (optax.global_norm)."""
    return torch.sqrt(sum((g * g).sum() for g in grads))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm / norm when norm >= max_norm
    (`optax.clip_by_global_norm`: `(g / norm) * max_norm`). Returns the norm."""
    grads = list(grads)
    norm = global_norm(grads)
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, (g / norm) * max_norm, g))
    return norm


def linear_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, pct_final: float = 0.85,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """`optax.linear_onecycle_schedule`: three linear phases through the
    boundaries int(pct_start * steps), int(pct_final * steps) and steps, from
    peak/div_factor up to peak, down to peak/div_factor, then to
    peak/div_factor/final_div_factor, held after the last boundary. Returns
    `schedule(count) -> float`; float32 arithmetic, as optax's under jit."""
    bounds = np.array([0, int(pct_start * transition_steps),
                       int(pct_final * transition_steps), transition_steps], np.int64)
    values = np.cumprod(np.array([peak_value / div_factor, div_factor, 1.0 / div_factor,
                                  1.0 / final_div_factor])).astype(np.float32)
    sizes = (bounds[1:] - bounds[:-1]).astype(np.float32)

    def schedule(count: int) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (np.float32(count) - bounds[:-1].astype(np.float32)) / sizes
            interp = (values[1:] - values[:-1]) * pct + values[:-1]
        inside = (bounds[:-1] <= count) & (count < bounds[1:])
        val = np.float32(np.where(inside, interp, np.float32(0)).sum(dtype=np.float32))
        if bounds[-1] <= count:
            val = val + values[-1]
        return float(np.float32(val))

    return schedule


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise `-y log sigmoid(x) - (1 - y) log sigmoid(-x)` in the
    log-sigmoid form optax uses."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class AdamW(torch.optim.AdamW):
    """torch.optim.AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)
    and a `set_lr` for a per-step rate."""

    def __init__(self, params, lr: float, weight_decay: float):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)

    def set_lr(self, lr: float) -> None:
        for group in self.param_groups:
            group["lr"] = lr


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype).to(like.device)


def adamw_state_dict(opt: AdamW, names, to_tree, schedule: bool) -> dict:
    """The optimizer state in optax's `to_state_dict` form of the trainers'
    `chain(clip_by_global_norm, adamw)`: {"0": {}, "1": {"0": adam, "1": {},
    "2": schedule count or {}}}.

    `names` are the parameter names in the optimizer's order; `to_tree(dict of
    numpy arrays keyed by name) -> nested flax tree` maps them the way the
    parameters themselves are mapped; `schedule`: adamw's rate is a schedule
    (its `scale_by_schedule` count), else a constant (an empty state)."""
    mu, nu, count = {}, {}, 0
    for name, p in zip(names, opt.param_groups[0]["params"]):
        st = opt.state.get(p, {})
        if st:
            count = int(st["step"])
            mu[name] = st["exp_avg"].detach().cpu().numpy()
            nu[name] = st["exp_avg_sq"].detach().cpu().numpy()
        else:
            mu[name] = np.zeros(tuple(p.shape), np.float32)
            nu[name] = np.zeros(tuple(p.shape), np.float32)
    c = np.asarray(count, np.int32)
    return {"0": {}, "1": {"0": {"count": c, "mu": to_tree(mu), "nu": to_tree(nu)}, "1": {},
                           "2": {"count": c.copy()} if schedule else {}}}


def load_adamw_state_dict(opt: AdamW, names, state: dict, from_tree) -> int:
    """Load optax's `to_state_dict` form of the chain's state (see
    `adamw_state_dict`) into `opt`; `from_tree(nested tree) -> dict of numpy
    arrays keyed by name`. Returns the update count."""
    adam = state["1"]["0"]
    count = int(adam["count"])
    mu, nu = from_tree(adam["mu"]), from_tree(adam["nu"])
    for name, p in zip(names, opt.param_groups[0]["params"]):
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": _tensor(mu[name], p).reshape(p.shape).clone(),
                        "exp_avg_sq": _tensor(nu[name], p).reshape(p.shape).clone()}
    return count


@torch.no_grad()
def flax_init_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """flax's default initial values: every conv and dense kernel from
    lecun_normal (a normal truncated at +-2 sigma, variance 1 / fan_in, fan_in
    the kernel's input size), zero biases, norm scales of 1, running means 0
    and variances 1. Draws come from `generator`, in parameter order."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    for name, b in module.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    return module


@contextlib.contextmanager
def tf32(enabled: bool = True):
    """TF32 for CUDA matmuls and cuDNN convolutions inside the block, the
    previous policy restored after it (the port's solvers keep TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
