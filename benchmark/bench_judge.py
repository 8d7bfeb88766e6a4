"""How `correct` is decided: what the timed path produced, held against the
plain references (`reference/`) on the same frames, and the converted poses
held against the renderer's cameras.

Every number is the worst over the window's checked sequences:
- flow: per sampled pair, the mean over pixels of the distance between the
  program's and the reference's flow vectors (px);
- depth: per sampled frame, the mean absolute gap of the [0, 1] depth;
- seg: the largest absolute gap of one sampled seg call's logits;
- tracks (one sequence a window, drawn from the seed): the plain tracker
  (`reference/tracker.py`) run on the flows the program's tracker was given,
  against the trajectories the program returned: the relative gap of their
  counts; of the trajectories born in the first frame (the same grid cells
  on both sides, matched by that cell), the share observed in other frames
  on one side than on the other or found on one side only; and the mean
  distance of their positions in the frames both observe (px);
- poses: the share of frames registered, the Sim3 ATE of the camera centres
  against the renderer's as a share of the RMS spread of those centres, and
  the focal's relative error.
A number is held to its limit from the configuration's `limits`
({"max": x} or {"min": x}); a stage that ran but gave no number fails.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch

import reference as refnets
from reference.depth import frame_depths
from reference.motionseg import window_logits
from reference.raft import pair_flows
from reference.tracker import track


def _umeyama_ate(est, gt) -> float:
    """RMSE of est centres [N, 3] after the least-squares similarity onto gt."""
    mu_s, mu_d = est.mean(0), gt.mean(0)
    xs, xd = est - mu_s, gt - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs ** 2).sum() / len(est)))
    aligned = s * est @ R.T + (mu_d - s * R @ mu_s)
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


def pose_numbers(out_dir: Path, seq) -> dict:
    """The converted poses (`colmap_outputs_converted/poses/<frame>.txt`,
    world->cam 3x4) and focal against the renderer's."""
    conv = Path(out_dir) / "colmap_outputs_converted"
    T = seq.scene.num_views
    est, gt, focal = [], [], None
    for v in range(T):
        p = conv / "poses" / f"{v:06d}.txt"
        if not p.exists():
            continue
        P = np.loadtxt(p).reshape(3, 4)
        G = seq.scene.w2c(v)
        est.append(-P[:, :3].T @ P[:, 3])
        gt.append(-G[:, :3].T @ G[:, 3])
        if focal is None:
            focal = float(np.loadtxt(conv / "intrinsics" / f"{v:06d}.txt").reshape(3, 3)[0, 0])
    out = {"poses.registered_share": len(est) / T}
    if len(est) >= 3:
        est, gt = np.array(est), np.array(gt)
        spread = float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(-1).mean()))
        out["poses.ate_rel"] = _umeyama_ate(est, gt) / spread
        out["poses.focal_err"] = abs(focal / seq.scene.K[0] - 1.0)
    return out


class Control:
    """The control: the references computed one precision below the
    configuration's (TF32 matmuls and convolutions for float32 with TF32
    off), put in the program's place."""

    @staticmethod
    @contextlib.contextmanager
    def tf32():
        m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c

    @staticmethod
    def bf16(flows: dict) -> dict:
        """The tracker's control: its flows held in bfloat16 (the tracker has
        no matmul or convolution that TF32 would touch)."""
        return {k: v.to(torch.bfloat16).to(v.dtype) for k, v in flows.items()}


def track_gaps(prog: tuple, ref: tuple) -> dict:
    """The program's trajectories (xy [N, T, 2], mask [N, T]) against the
    reference's."""
    (xp, mp), (xr, mr) = prog, ref
    out = {"tracks.count_gap": abs(len(xp) - len(xr)) / max(len(xr), 1)}

    def first_frame(xy, mask):
        rows = np.nonzero(mask[:, 0])[0]
        key = np.round(xy[rows, 0, 1] * 32).astype(np.int64) * (1 << 20) \
            + np.round(xy[rows, 0, 0] * 32).astype(np.int64)
        order = np.argsort(key)
        return key[order], rows[order]

    kp, rp = first_frame(xp, mp)
    kr, rr = first_frame(xr, mr)
    both, ip, ir = np.intersect1d(kp, kr, assume_unique=True, return_indices=True)
    rp, rr = rp[ip], rr[ir]
    same = (mp[rp] == mr[rr]).all(1)
    alone = len(kp) + len(kr) - 2 * len(both)
    out["tracks.mismatched_frac"] = (int((~same).sum()) + alone) / max(len(kr), 1)
    shared = mp[rp] & mr[rr]
    d = np.linalg.norm(xp[rp] - xr[rr], axis=-1)[shared]
    out["tracks.gap_mean_px"] = float(d.mean()) if d.size else float("inf")
    return out


class Judge:
    """References on `device`, loaded from the configuration's checkpoints."""

    def __init__(self, root: Path, config: dict, device):
        ck, dev = config["checkpoints"], torch.device(device)
        self.device = dev
        self.raft_cfg = config["raft"]
        self.raft = refnets.load_raft(root / ck["raft"], self.raft_cfg["width"]).to(dev)
        self.track_cfg = config["track"]
        self.depth = self.seg = None
        if "depth" in ck:
            self.depth = refnets.load_depth(root / ck["depth"], config["depth"]["base"]).to(dev)
        if "seg" in ck:
            self.seg = refnets.load_seg(root / ck["seg"], config["seg"]["input_hw"]).to(dev)

    @torch.inference_mode()
    def ref_flows(self, frames, ia, ib):
        fr = torch.as_tensor(frames)
        rc = self.raft_cfg
        return pair_flows(self.raft, fr[ia].to(self.device), fr[ib].to(self.device), rc["iters"],
                          [tuple(p) for p in rc["refine_schedule"]], rc["refine_max_total_px"])

    @torch.inference_mode()
    def ref_depths(self, frames, idx):
        return frame_depths(self.depth, torch.as_tensor(frames)[idx].to(self.device))

    @torch.inference_mode()
    def ref_logits(self, traj, depth, valid):
        return window_logits(self.seg, torch.as_tensor(traj.astype(np.int32)).to(self.device),
                             torch.as_tensor(depth).to(self.device),
                             torch.as_tensor(valid).to(self.device))

    def ref_tracks(self, flows: dict, height: int, width: int, control: bool = False):
        flows = {k: v.to(self.device) for k, v in flows.items()}
        if control:
            flows = Control.bf16(flows)
        with torch.inference_mode():
            return track(flows, self.track_cfg, height, width)

    def numbers(self, cap, seq, control: bool = False) -> dict:
        """The numbers of one checked sequence. With `control` the
        references in TF32 stand in the program's place."""
        out = {}
        with torch.inference_mode():
            if cap.flows is not None:
                ref = self.ref_flows(seq.frames, cap.pair_ia, cap.pair_ib)
                prog = cap.flows.to(self.device)
                if control:
                    with Control.tf32():
                        prog = self.ref_flows(seq.frames, cap.pair_ia, cap.pair_ib)
                gap = torch.linalg.vector_norm(prog - ref, dim=-1)
                out["flow.gap_mean_px"] = float(gap.mean(dim=(1, 2)).max())
                out["flow.gap_max_px"] = float(gap.max())
            if cap.depth is not None and self.depth is not None:
                ref = self.ref_depths(seq.frames, cap.depth_idx)
                prog = cap.depth.to(self.device)
                if control:
                    with Control.tf32():
                        prog = self.ref_depths(seq.frames, cap.depth_idx)
                gap = (prog - ref).abs()
                out["depth.gap_mean"] = float(gap.mean(dim=(1, 2)).max())
            if cap.seg is not None and self.seg is not None:
                traj, depth, valid, logits = cap.seg
                ref = self.ref_logits(traj, depth, valid)
                prog = torch.as_tensor(logits).to(self.device)
                if control:
                    with Control.tf32():
                        prog = self.ref_logits(traj, depth, valid)
                gap = (prog - ref).abs()
                out["seg.gap_max"] = float(gap.max())
        if cap.track_out is not None:
            H, W = seq.frames.shape[1:3]
            ref = self.ref_tracks(cap.track_flows, H, W)
            prog = self.ref_tracks(cap.track_flows, H, W, control=True) if control \
                else cap.track_out
            out.update(track_gaps(prog, ref))
        return out


def expected_numbers(flags) -> set:
    """The prefixes of the numbers a cell with these pipeline flags must give."""
    out = {"flow.", "tracks."}
    if "--assume_static" not in flags:
        out |= {"depth.", "seg."}
    if "--skip_sfm" not in flags:
        out.add("poses.")
    return out


def worst(readings: list) -> dict:
    """Per number, the worst reading over sequences: the least of a share
    held from below, the largest of a gap."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k not in out:
                out[k] = v
            else:
                out[k] = min(out[k], v) if k.endswith("_share") else max(out[k], v)
    return out


def verdict(numbers: dict, limits: dict, flags) -> tuple:
    """(correct, [(name, value, limit text)]) for the limits that apply to a
    cell with these flags."""
    want = expected_numbers(flags)
    rows, ok = [], True
    for name, lim in limits.items():
        if not any(name.startswith(p) for p in want):
            continue
        v = numbers.get(name)
        if "max" in lim:
            good = v is not None and v <= lim["max"]
            text = f"<= {lim['max']}"
        else:
            good = v is not None and v >= lim["min"]
            text = f">= {lim['min']}"
        ok &= good
        rows.append((name, v, text))
    return ok, rows
