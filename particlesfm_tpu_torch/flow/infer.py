"""Flow-net inference: checkpoint loading, padding, and the pair-indexed
apply over a device mesh (port of particlesfm_tpu/flow/infer.py).

Checkpoints carry a sidecar JSON with the model configuration, so the compact
(in-environment-trained) variant and the full width load through one path.
Inputs are edge-padded to a multiple of 8 and the flow cropped back; with
scale < 1 the net runs on the padded frames resized to `scale` (rounded to a
multiple of 8), and its flow is resized back and rescaled.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..io.checkpoint import (load_msgpack, loaded, raft_state_dict_from_jax,
                             raft_variables_from_torch, save_msgpack)
from ..models.depth import resize_bilinear
from ..models.raft import RAFT, compact_raft
from ..parallel.mesh import mesh_for
from ..utils import profiling


def _pad8(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-pad a batch [B, H, W, C] by ph rows and pw columns."""
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)


def _resize_nhwc(x: torch.Tensor, size) -> torch.Tensor:
    return resize_bilinear(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def _net_flow(model, i1: torch.Tensor, i2: torch.Tensor, iters: int, scale: float):
    """Flow [B, Hp, Wp, 2] of padded pairs [B, Hp, Wp, 3]. With scale != 1
    the net sees the frames resized to (round(Hp*scale/8)*8,
    round(Wp*scale/8)*8) (Python's round, half to even), and its flow is
    resized back and scaled by [Wp/ws, Hp/hs]."""
    if scale == 1.0:
        return model(i1, i2, iters=iters)
    Hp, Wp = i1.shape[1:3]
    hs = int(round(Hp * scale / 8.0)) * 8
    ws = int(round(Wp * scale / 8.0)) * 8
    fl = model(_resize_nhwc(i1, (hs, ws)), _resize_nhwc(i2, (hs, ws)), iters=iters)
    fl = _resize_nhwc(fl, (Hp, Wp))
    return fl * torch.tensor([Wp / ws, Hp / hs], dtype=fl.dtype, device=fl.device)


VARIANTS = {"compact": compact_raft, "things": RAFT}


def model_from_meta(meta: dict) -> RAFT:
    """The RAFT a checkpoint's sidecar names: "compact" (the default when
    the sidecar or its `variant` is missing) or "things", the published
    raft-things widths."""
    variant = meta.get("variant", "compact")
    if variant not in VARIANTS:
        raise ValueError(f"unknown RAFT variant {variant!r} (known: {', '.join(VARIANTS)})")
    return VARIANTS[variant]()


def save_flow_checkpoint(path, model: RAFT, variant: str = "compact", extra: dict | None = None):
    """Write a flow checkpoint either package loads: the flax msgpack blob
    {"params": tree} of the model's weights, with {"batch_stats": tree}
    for a batch-norm context encoder, and the `.json` sidecar
    {"variant", **extra} (reference flow/infer.py:41-51)."""
    path = Path(path)
    save_msgpack(path, raft_variables_from_torch(model.state_dict()))
    meta = {"variant": variant}
    meta.update(extra or {})
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=2))


def load_flow_checkpoint(path):
    """-> (params tree of numpy arrays, batch_stats tree ({} without batch
    norm), sidecar meta dict)."""
    blob = load_msgpack(path)
    meta_path = Path(str(path) + ".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return blob["params"], blob.get("batch_stats", {}), meta


def load_model(path, device) -> tuple:
    """RAFT with the checkpoint's weights (strict load), in eval mode on
    `device`, and the checkpoint's meta."""
    params, stats, meta = load_flow_checkpoint(path)
    return loaded(model_from_meta(meta), raft_state_dict_from_jax(params, stats), device), meta


def load_flow_apply_pairs(ckpt, iters=None, mesh=None, per_device: int = 8,
                          scale: float = 1.0, refine_schedule=None,
                          refine_max_total: float = 3.0, device="cuda"):
    """Pair-indexed flow apply against a device-resident uint8 frame stack,
    data-parallel over a device mesh.

    Returns `apply(stack, ia, ib) -> flows [N, H, W, 2]` (on the mesh's
    entry 0) where `stack` is the uint8 frame stack [T, H, W, 3] (tensor or
    numpy; placed on each mesh device once a call) and ia/ib are frame
    indices per pair. Pairs run in blocks of `per_device` by the mesh's rule
    (`Mesh.map_blocks`: block g on entry g % size, the last block ragged),
    so every net call sees the batch it sees on one device. scale < 1 runs
    the net at reduced resolution (`_net_flow`). With `refine_schedule`
    ((iters, sigma, radius) phases) the photometric refinement runs right
    after the net on each block, at full resolution: this is the pipeline's
    only refinement. With tracing on (`utils.profiling`) each block's net
    and refinement are spans `flow.net` and `flow.refine`, timed on the
    block's own device.

    mesh=None: one device, `device`, or every visible card for a bare
    "cuda" (`parallel.mesh.mesh_for`).
    """
    if mesh is None:
        mesh = mesh_for(resolve_device(device))
    params, stats, meta = load_flow_checkpoint(ckpt)
    sd = raft_state_dict_from_jax(params, stats)
    models = mesh.replicate(lambda d: loaded(model_from_meta(meta), sd, d))
    n_iters = int(iters) if iters is not None else int(meta.get("iters", 12))

    @torch.inference_mode()
    def run_block(model, stack, ia, ib):
        with profiling.span("flow.net", device=stack.device):
            raw1 = stack[ia].to(torch.float32)
            raw2 = stack[ib].to(torch.float32)
            H, W = raw1.shape[1:3]
            ph, pw = (-H) % 8, (-W) % 8
            i1, i2 = raw1, raw2
            if ph or pw:        # edge-pad to a multiple of 8 (infer.py:194-199)
                i1, i2 = _pad8(raw1, ph, pw), _pad8(raw2, ph, pw)
            fl = _net_flow(model, i1, i2, n_iters, scale)[:, :H, :W]
        if refine_schedule:
            from .refine import photometric_refine_scheduled

            with profiling.span("flow.refine", device=stack.device):
                fl = photometric_refine_scheduled(
                    raw1 / 255.0, raw2 / 255.0, fl,
                    schedule=refine_schedule, max_total=refine_max_total)
        return fl

    def apply(stack, ia, ib):
        ia, ib = np.asarray(ia, np.int64), np.asarray(ib, np.int64)
        stacks = mesh.place(torch.as_tensor(stack))
        # the indices go up once a call, not per block: a pageable copy
        # inside the block loop would synchronise the stream each block
        ias, ibs = mesh.place(torch.as_tensor(ia)), mesh.place(torch.as_tensor(ib))
        return mesh.map_blocks(
            lambda d, lo, hi: run_block(models[d], stacks[d], ias[d][lo:hi], ibs[d][lo:hi]),
            len(ia), per_device)

    return apply
