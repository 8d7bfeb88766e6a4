"""Dense point-trajectory engine (port of particlesfm_tpu/tracks/engine.py).

Trajectories live in a fixed-capacity slot pool (tensors [C] on the device);
births and deaths are mask updates plus rank-based slot allocation. The JAX
`lax.scan` over frames is a Python loop here, with the state held as device
tensors. Per frame f (upstream's track_optimize.py:31-50):
  1. spawn new trajectories on all currently-free grid cells (time f);
  2. sample stride-1 flow at active heads, step to time f+1; kill on
     occlusion (sampled occ > 0.1) or out-of-bounds (0 < x < W-1 strictly);
  3. occupancy of the surviving new positions -> next frame's free cells
     (no occupied pixel within Euclidean distance sample_ratio);
  4. trajectories with >= 3 buffered positions jointly refine their
     positions at (f, f+1) against the flow01/flow02 anchors and flow12.

The reference's `.at[].set(mode="drop")` scatters address a sentinel index
(C, W or H) for entries they drop; here those entries are masked out before
the write (never clamped, which would write slot C-1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..ops.density import free_cell_mask
from ..ops.sampling import bilinear_sample
from .optimize import optimize_locations


@dataclass(frozen=True)
class TrackerConfig:
    sample_ratio: int = 2
    capacity: int = 1 << 17
    path_consistency: bool = True
    upper_flow: float = 20.0   # flow02 anchor gate (trajectory.py:179)
    gn_iters: int = 12
    patch_lm: bool = True      # per-point flow patches inside the LM loop


class TrackerOutput(NamedTuple):
    positions: torch.Tensor   # [T+1, C, 2] position of slot's trajectory at time t
    traj_ids: torch.Tensor    # [T+1, C] int32, -1 where invalid
    valid: torch.Tensor       # [T+1, C] bool
    num_trajs: torch.Tensor   # scalar int32
    overflow: torch.Tensor    # scalar int32 — spawns dropped due to pool overflow


def _candidate_grid(height: int, width: int, ratio: int, device) -> torch.Tensor:
    """Candidate cell centers [G, 2] in row-major order (xys[::ratio, ::ratio])."""
    ys = torch.arange(0, height, ratio, dtype=torch.float32, device=device)
    xs = torch.arange(0, width, ratio, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def _masked_set(dst: torch.Tensor, index: torch.Tensor, keep: torch.Tensor, src):
    """dst[index[keep]] = src[keep] (src may be a scalar); entries not kept
    are dropped. Returns a new tensor."""
    out = dst.clone()
    if torch.is_tensor(src) and src.dim() > 0:
        src = src[keep]
    out[index[keep]] = src
    return out


def run_tracker(
    flows: torch.Tensor,              # [T, H, W, 2] stride-1 forward flow
    occs: torch.Tensor,               # [T, H, W] stride-1 occlusion masks
    flows2: Optional[torch.Tensor],   # [T-1, H, W, 2] stride-2 forward flow (or None)
    occs2: Optional[torch.Tensor],    # [T-1, H, W] stride-2 occlusion masks (or None)
    cfg: TrackerConfig,
    height: int,
    width: int,
) -> TrackerOutput:
    """Track over all frames on the device of `flows`."""
    dev = flows.device
    T = flows.shape[0]
    C = cfg.capacity
    ratio = cfg.sample_ratio
    cand_xy = _candidate_grid(height, width, ratio, dev)      # [G, 2]
    G = cand_xy.shape[0]
    use_pc = cfg.path_consistency and flows2 is not None
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.arange(C, **i32)

    pos = torch.zeros(C, 2, device=dev)
    prev1 = torch.zeros(C, 2, device=dev)
    prev2 = torch.zeros(C, 2, device=dev)
    active = torch.zeros(C, dtype=torch.bool, device=dev)
    traj_id = torch.full((C,), -1, **i32)
    start_time = torch.zeros(C, **i32)
    next_id = torch.zeros((), **i32)
    cand = torch.ones(G, dtype=torch.bool, device=dev)
    overflow = torch.zeros((), **i32)

    pos_seq = torch.empty(T + 1, C, 2, device=dev)
    id_seq = torch.empty(T + 1, C, **i32)
    valid_seq = torch.empty(T + 1, C, dtype=torch.bool, device=dev)

    for f in range(T):
        flow_map = flows[f]
        occ_map = occs[f]

        # --- 1. spawn on free candidate cells --------------------------------
        free = ~active
        num_free = free.sum(dtype=torch.int32)
        free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
        slot_of_rank = _masked_set(torch.full((C,), C, **i32), free_rank.long(), free, slots)

        cand_rank = torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
        num_cand = cand.sum(dtype=torch.int32)
        spawnable = cand & (cand_rank < num_free)
        target = slot_of_rank[cand_rank.clamp(0, C - 1).long()].long()

        pos = _masked_set(pos, target, spawnable, cand_xy)
        traj_id = _masked_set(traj_id, target, spawnable, next_id + cand_rank)
        start_time = _masked_set(start_time, target, spawnable, f)
        active = _masked_set(active, target, spawnable, True)
        next_id = next_id + torch.minimum(num_cand, num_free)
        overflow = overflow + torch.clamp(num_cand - num_free, min=0)

        # --- 2. step heads by flow, kill on occlusion / out-of-bounds --------
        flow_at = bilinear_sample(flow_map, pos)
        occ_at = bilinear_sample(occ_map[..., None], pos)[..., 0]
        nxt = pos + flow_at
        inb = (
            (nxt[:, 0] > 0) & (nxt[:, 0] < width - 1)
            & (nxt[:, 1] > 0) & (nxt[:, 1] < height - 1)
        )
        survive = active & inb & (occ_at <= 0.1)

        # --- 3. occupancy of surviving new positions -> next candidates ------
        ix = nxt[:, 0].to(torch.int64)
        iy = nxt[:, 1].to(torch.int64)
        occupied = _masked_set(torch.zeros(height * width, device=dev),
                               iy * width + ix, survive, 1.0).view(height, width)
        cand = free_cell_mask(occupied, float(ratio))[::ratio, ::ratio].reshape(-1) > 0

        # --- shift history buffers for survivors ------------------------------
        s2 = survive[:, None]
        prev2 = torch.where(s2, prev1, prev2)
        prev1 = torch.where(s2, pos, prev1)
        new_pos = torch.where(s2, nxt, pos)

        # --- 4. path-consistency refinement of times (f, f+1) ----------------
        if use_pc:
            eligible = survive & (start_time <= f - 1)
            fprev = max(f - 1, 0)
            x0 = prev2
            f01 = bilinear_sample(flows[fprev], x0)
            f02 = bilinear_sample(flows2[fprev], x0)
            o02 = bilinear_sample(occs2[fprev][..., None], x0)[..., 0]
            uv_ref1 = x0 + f01
            uv_ref2 = x0 + f02
            f02_norm = torch.sqrt((f02 * f02).sum(-1))
            scale = (1.0 - o02) * (f02_norm < cfg.upper_flow).to(o02.dtype)
            p = torch.cat([prev1, new_pos], dim=-1)
            p_opt = optimize_locations(
                p, uv_ref1, uv_ref2, scale, flow_map,
                mask=eligible.to(p.dtype), num_iters=cfg.gn_iters, patch=cfg.patch_lm)
            e2 = eligible[:, None]
            prev1 = torch.where(e2, p_opt[:, 0:2], prev1)
            new_pos = torch.where(e2, p_opt[:, 2:4], new_pos)

        # --- emit final positions at time f -----------------------------------
        # survivors: refined prev1 (time f); dying slots: their unstepped head
        pos_seq[f] = torch.where(s2, prev1, pos)
        id_seq[f] = torch.where(active, traj_id, torch.full_like(traj_id, -1))
        valid_seq[f] = active

        pos = new_pos
        active = survive

    # final row: positions at time T of still-active trajectories
    pos_seq[T] = pos
    id_seq[T] = torch.where(active, traj_id, torch.full_like(traj_id, -1))
    valid_seq[T] = active
    return TrackerOutput(positions=pos_seq, traj_ids=id_seq, valid=valid_seq,
                         num_trajs=next_id, overflow=overflow)
