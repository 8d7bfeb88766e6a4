"""Flow-net inference: checkpoint loading and pair-indexed block apply
(port of particlesfm_tpu/flow/infer.py:33-60,149-285).

Checkpoints carry a sidecar JSON with the model configuration, so the compact
(in-environment-trained) variant and the full width load through one path.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..io.checkpoint import load_msgpack, raft_state_dict_from_jax
from ..models.raft import RAFT, compact_raft


def model_from_meta(meta: dict) -> RAFT:
    if meta.get("variant", "compact") == "compact":
        return compact_raft()
    return RAFT()


def load_flow_checkpoint(path):
    """-> (params tree of numpy arrays, sidecar meta dict)."""
    blob = load_msgpack(path)
    meta_path = Path(str(path) + ".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return blob["params"], meta


def load_model(path, device) -> tuple:
    """RAFT with the checkpoint's weights (strict load), in eval mode on
    `device`, and the checkpoint's meta."""
    params, meta = load_flow_checkpoint(path)
    model = model_from_meta(meta)
    model.load_state_dict(raft_state_dict_from_jax(params), strict=True)
    return model.to(device).eval(), meta


def load_flow_apply_pairs(ckpt, iters=None, per_device: int = 8, scale: float = 1.0,
                          refine_schedule=None, refine_max_total: float = 3.0,
                          device="cuda"):
    """Pair-indexed flow apply against a device-resident uint8 frame stack.

    Returns `apply(stack, ia, ib) -> flows [N, H, W, 2]` (on `device`) where
    `stack` is the uint8 frame stack [T, H, W, 3] (tensor or numpy; moved to
    `device` once) and ia/ib are frame indices per pair. Pairs run in blocks
    of `per_device`; each block's correlation pyramid is freed before the
    next block starts. With `refine_schedule` ((iters, sigma, radius) phases)
    the photometric refinement runs right after the net on each block and the
    returned apply carries `.refines = True`.
    """
    if scale != 1.0:
        raise NotImplementedError(
            "flow.infer_scale != 1 (reduced-resolution flow) is not ported yet")
    dev = resolve_device(device)
    model, meta = load_model(ckpt, dev)
    n_iters = int(iters) if iters is not None else int(meta.get("iters", 12))

    @torch.inference_mode()
    def run_block(stack, ia, ib):
        raw1 = stack[ia].to(torch.float32)
        raw2 = stack[ib].to(torch.float32)
        H, W = raw1.shape[1:3]
        ph, pw = (-H) % 8, (-W) % 8
        i1, i2 = raw1, raw2
        if ph or pw:        # edge-pad to a multiple of 8 (infer.py:194-199)
            i1, i2 = (F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
                      .permute(0, 2, 3, 1) for x in (raw1, raw2))
        fl = model(i1, i2, iters=n_iters)[:, :H, :W]
        if refine_schedule:
            from .refine import photometric_refine_scheduled

            fl = photometric_refine_scheduled(
                raw1 / 255.0, raw2 / 255.0, fl,
                schedule=refine_schedule, max_total=refine_max_total)
        return fl

    def apply(stack, ia, ib):
        stack = torch.as_tensor(stack).to(dev)
        ia = torch.as_tensor(np.asarray(ia, np.int64), device=dev)
        ib = torch.as_tensor(np.asarray(ib, np.int64), device=dev)
        out = [run_block(stack, ia[k:k + per_device], ib[k:k + per_device])
               for k in range(0, len(ia), per_device)]
        return torch.cat(out, 0)

    apply.refines = refine_schedule is not None
    return apply
