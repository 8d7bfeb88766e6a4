"""Flow-net inference: checkpoint loading, padding, and the single-pair,
batched, pair-indexed and mesh-sharded applies (port of
particlesfm_tpu/flow/infer.py).

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
from ..io.checkpoint import (load_msgpack, raft_state_dict_from_jax,
                             raft_variables_from_torch, save_msgpack)
from ..models.depth import resize_bilinear
from ..models.raft import RAFT, compact_raft
from ..parallel.mesh import mesh_for
from ..utils import profiling


def pad_to_multiple(img, mult: int = 8):
    """Edge-pad one image [H, W, C] (numpy or tensor) to multiples of
    `mult`; returns (padded, (H, W))."""
    H, W = img.shape[0], img.shape[1]
    ph, pw = (-H) % mult, (-W) % mult
    if ph == 0 and pw == 0:
        return img, (H, W)
    if torch.is_tensor(img):
        return _pad8(img[None], ph, pw)[0], (H, W)
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge"), (H, W)


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
    model = model_from_meta(meta)
    model.load_state_dict(raft_state_dict_from_jax(params, stats), strict=True)
    return model.to(device).eval(), meta


def load_flow_apply(ckpt, iters: int = 12, device="cuda"):
    """`apply(img1, img2) -> flow [H, W, 2]` (on `device`) for one pair of
    images [H, W, 3] in [0, 255]. The GRU iteration count is the
    checkpoint's recorded one when it has one, else `iters`."""
    dev = resolve_device(device)
    model, meta = load_model(ckpt, dev)
    n_iters = int(meta.get("iters", iters))

    @torch.inference_mode()
    def apply(img1, img2):
        img1 = torch.as_tensor(np.asarray(img1), dtype=torch.float32).to(dev)
        img2 = torch.as_tensor(np.asarray(img2), dtype=torch.float32).to(dev)
        p1, (H, W) = pad_to_multiple(img1)
        p2, _ = pad_to_multiple(img2)
        return model(p1[None], p2[None], iters=n_iters)[0, :H, :W]

    return apply


def load_flow_apply_batch(ckpt, iters=None, scale: float = 1.0, device="cuda"):
    """`apply(img1s, img2s) -> flows [B, H, W, 2]` (on `device`) for a batch
    of image pairs [B, H, W, 3] in [0, 255]. iters=None uses the checkpoint's
    recorded count (default 12); scale < 1 runs the net at reduced
    resolution (`_net_flow`)."""
    dev = resolve_device(device)
    model, meta = load_model(ckpt, dev)
    n_iters = int(iters) if iters is not None else int(meta.get("iters", 12))

    @torch.inference_mode()
    def apply(img1s, img2s):
        img1s = torch.as_tensor(np.asarray(img1s), dtype=torch.float32).to(dev)
        img2s = torch.as_tensor(np.asarray(img2s), dtype=torch.float32).to(dev)
        H, W = img1s.shape[1:3]
        ph, pw = (-H) % 8, (-W) % 8
        if ph or pw:
            img1s, img2s = _pad8(img1s, ph, pw), _pad8(img2s, ph, pw)
        return _net_flow(model, img1s, img2s, n_iters, scale)[:, :H, :W]

    return apply


def _replicas(ckpt, mesh):
    """One RAFT per distinct device of `mesh`, each loaded from the same
    converted state dict; and the checkpoint's meta."""
    params, stats, meta = load_flow_checkpoint(ckpt)
    sd = raft_state_dict_from_jax(params, stats)
    models = {}
    for d in mesh.distinct():
        model = model_from_meta(meta)
        model.load_state_dict(sd, strict=True)
        models[d] = model.to(d).eval()
    return models, meta


def load_flow_apply_pairs(ckpt, iters=None, mesh=None, per_device: int = 8,
                          scale: float = 1.0, refine_schedule=None,
                          refine_max_total: float = 3.0, device="cuda"):
    """Pair-indexed flow apply against a device-resident uint8 frame stack,
    data-parallel over a device mesh.

    Returns `apply(stack, ia, ib) -> flows [N, H, W, 2]` (on the mesh's
    entry 0) where `stack` is the uint8 frame stack [T, H, W, 3] (tensor or
    numpy; moved to each mesh device once) and ia/ib are frame indices per
    pair. Pairs run in blocks of `per_device * mesh size`; each block is
    split into contiguous groups of `per_device`, one per mesh entry, so
    every net call sees the batch it sees on one device (the last, ragged
    block is split the same way, unpadded). Every shard of every block is
    issued before the flows are gathered. scale < 1 runs the net at reduced
    resolution (`_net_flow`). With `refine_schedule` ((iters, sigma, radius)
    phases) the photometric refinement runs right after the net on each
    shard, at full resolution, and the returned apply carries
    `.refines = True`. With tracing on (`utils.profiling`) each block's net
    and refinement are spans `flow.net` and `flow.refine`, timed on the
    block's own device.

    mesh=None: one device, `device`, or every visible card for a bare
    "cuda" (`parallel.mesh.mesh_for`).
    """
    if mesh is None:
        mesh = mesh_for(resolve_device(device))
    models, meta = _replicas(ckpt, mesh)
    n_iters = int(iters) if iters is not None else int(meta.get("iters", 12))
    devs = mesh.flat

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
        stack = torch.as_tensor(stack)
        stacks = {d: stack.to(d) for d in models}
        ia = np.asarray(ia, np.int64)
        ib = np.asarray(ib, np.int64)
        idx = {d: (torch.as_tensor(ia, device=d), torch.as_tensor(ib, device=d))
               for d in models}
        out = []
        for g, lo in enumerate(range(0, len(ia), per_device)):
            d = devs[g % len(devs)]
            a, b = idx[d]
            out.append(run_block(models[d], stacks[d], a[lo:lo + per_device],
                                 b[lo:lo + per_device]))
        return torch.cat([f.to(devs[0]) for f in out], 0)

    apply.refines = refine_schedule is not None
    return apply


def load_flow_apply_sharded(ckpt, iters=None, mesh=None, per_device: int = 8,
                            scale: float = 1.0, device="cuda"):
    """Flow apply over an arbitrary list of image pairs, data-parallel over a
    device mesh (reference flow/infer.py:288-330).

    Returns `apply(img1s, img2s) -> flows [N, H, W, 2]` (numpy) for host
    image pairs [N, H, W, 3] in [0, 255]: blocks of `per_device * mesh
    size` pairs, each split into contiguous groups of `per_device`, one per
    mesh entry, run through `load_flow_apply_batch`'s apply on that entry's
    device. mesh=None as in `load_flow_apply_pairs`."""
    if mesh is None:
        mesh = mesh_for(resolve_device(device))
    devs = mesh.flat
    base = {d: load_flow_apply_batch(ckpt, iters=iters, scale=scale, device=d)
            for d in mesh.distinct()}

    def apply(img1s, img2s):
        img1s = np.asarray(img1s, np.float32)
        img2s = np.asarray(img2s, np.float32)
        out = [base[devs[g % len(devs)]](img1s[lo:lo + per_device], img2s[lo:lo + per_device])
               for g, lo in enumerate(range(0, img1s.shape[0], per_device))]
        return np.concatenate([f.cpu().numpy() for f in out], 0)

    return apply
