"""Smoke run of the PyTorch/CUDA port on one GPU: builds kernel K1, holds it
against its plain version, drives the port's main path and checks its output.

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --profile  # also device time by kernel of one more run
    python3 chip_smoke.py --dump DIR  # also the checks' inputs, for the JAX compare
                                      # (and a labeled-track subset + selfcal.json)

Phases (each prints its lines; any failure exits non-zero):
  1. device  — CUDA required; card name and power limit from nvidia-smi.
  2. build   — nvcc builds csrc/corr_lookup.cu (sm_90a); the r=4, 4-level
               kernel's `-Xptxas -v` registers and spills (a spill fails
               the run).
  3. kernel  — K1 vs the plain lookup at the main path's block shape
               (8 pairs, 55x128 level 0, 4 levels, r=4) on synthetic
               coordinates: max error, exact zeros off the map, times
               (kernel, plain, F.grid_sample) and the bound.
  4. slice   — renders the acceptance set's seq_03_dyn (seed 0, 1024x436,
               48 frames) and runs the user's default `run_pipeline` (global
               SfM included) on the card: K1 launch count, finite flows,
               stride-1 EPE against the renderer's ground truth, tracks; then
               [selfcal]   selfcal.json interior and within 6% of the
                           renderer's focal; the card's estimate from the
                           run's flows against the CPU's, same draws;
               [depth]     48 normalized frames; the run's depth apply on the
                           card against the CPU on a block of 4 frames, and
                           against the run's own depth; correlation with GT;
               [motionseg] the labeled tracks of a stage that ran; the run's
                           seg apply on the card against the CPU on the first
                           and the last (padded) chunk of the run's own
                           input, and against the run's labels; IoU vs GT.
  5. modes   — every other run_pipeline option on the same frames:
               (a) `--sfm_type incremental` as the user's command: K1
                   launches, model and converted outputs, >= 3 registered
                   frames with finite poses; the first PnP registration and
                   the first BA card vs CPU; the incremental stage repeated
                   (same registration order, bit-identical poses);
               (b) `sfm.position.method=linear` and `=nonlinear` on the
                   default run's labeled tracks: each estimator card vs CPU;
               (c) the default run's last BA problem with solver="pcg",
                   card vs CPU, and its gap to the dense solve;
               (d) the flow stage with `flow.infer_scale=0.5` and
                   `flow.stride2_compose_disagree_px=4`: K1 at the 28x64
                   shape, finite flows, stride-1 EPE, the fallback card vs
                   CPU on the run's own flows; one block through RAFT with
                   K1 and with the plain lookup at 224x512 (`[kernel-half]`).
  6. net     — one block of 8 pairs through RAFT with K1 and with the plain
               lookup on the card; the flows must agree. `[kernel-net]`: the
               measurements of phase 3 on the pyramid and coordinates of the
               block's last GRU iteration (the net's own coordinates).
The last two lines are the card's `name, power.limit` and
{"ok": true, "device": {...}}; the line before them lists the kernels (the
`*_net` keys are the `[kernel-net]` numbers, the `*_half` keys those of
`[kernel-half]` and the half-scale flow stage's launches).
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "runs" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
SEQ = dict(seed=0, idx=3, h=436, w=1024)   # seq_03_dyn, make_acceptance_set.py:50-83
FRAMES = 48                    # the sequence length of the acceptance set
GT_PAIRS = 8                   # stride-1 pairs scored against ground truth
SFM_DUMP_TRACKS = 30_000       # --dump: the labeled-track subset the JAX compare reruns


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- rendering --

def _scene(frames: int, seed: int, idx: int, h: int, w: int):
    """Sequence idx of scripts/make_acceptance_set.py (render_sequence)."""
    from particlesfm_tpu_torch.synth import random_scene

    rng = np.random.default_rng(1000003 * seed + idx)
    focal = 1.2 * w * rng.uniform(0.85, 1.15)
    return random_scene(
        rng, num_views=frames, height=h, width=w, focal=focal,
        num_dynamic=int(rng.integers(1, 3)),
        motion_scale=float(rng.uniform(0.06, 0.20)),
        rot_scale=float(rng.uniform(0.08, 0.32)),
        num_static_obj=int(rng.integers(6, 13)),
    )


def _render_frame(job):
    """Worker: write frame i as PPM; return its GT moving-object mask and,
    for the first GT_PAIRS frames, the GT stride-1 flow i->i+1 and the GT
    normalized inverse depth."""
    from PIL import Image

    i, frames, seq, img_dir, want_gt = job
    sc = _scene(frames, **seq)
    Image.fromarray(sc.render(i)).save(Path(img_dir) / f"{i:06d}.ppm")
    extra = (sc.gt_flow(i, i + 1), sc.gt_inverse_depth_norm(i)) if want_gt else None
    return i, sc.gt_dynamic(i), extra


def render_sequence(frames: int, img_dir: Path) -> dict:
    """Frames as PPM files; GT flow and inverse depth of the first GT_PAIRS
    frames, moving-object masks of all, the scene's focal and its 3x4
    world-to-camera poses."""
    img_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(i, frames, SEQ, str(img_dir), i < GT_PAIRS) for i in range(frames)]
    dyn, extra = {}, {}
    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        for i, d, e in pool.imap_unordered(_render_frame, jobs):
            dyn[i] = d
            if e is not None:
                extra[i] = e
    sc = _scene(frames, **SEQ)
    return dict(flow=np.stack([extra[i][0] for i in range(GT_PAIRS)]),
                inv_depth=np.stack([extra[i][1] for i in range(GT_PAIRS)]),
                dynamic=np.stack([dyn[i] for i in range(frames)]),
                focal=float(sc.K[0]),
                w2c=np.stack([sc.world_to_cam(i) for i in range(frames)]))


def ptxas_lines(log_text: str, entry: str):
    """The `-Xptxas -v` lines (registers, shared memory, stack, spills) of
    the kernel entries whose mangled name contains `entry`."""
    mine, out = False, []
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            mine = entry in ln
        elif mine and any(w in ln for w in ("registers", "smem", "spill")):
            out.append(ln.split(":", 1)[-1].strip())
    return out


# ------------------------------------------------------------------ timing --

def time_ms(fn, launches: int = 20, rounds: int = 5, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around `launches` back-to-back
    calls, divided by their count; the median over `rounds` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


# ------------------------------------------------------------------ phases --

def measure_lookup(tag: str, pyr, coords, r: int, vec: bool = True) -> dict:
    """K1 vs plain on these inputs (max error, exact zeros where a level's
    window lies off the map), times of K1, plain and one F.grid_sample per
    level, and the bound from this data's byte count. `vec`: whether K1 must
    copy these windows in 16-byte chunks (else 4-byte elements)."""
    import torch
    import torch.nn.functional as F

    from particlesfm_tpu_torch.ops import corr_lookup as cl

    B, P = coords.shape[:2]
    before = cl.vec_launches
    out_k = cl.lookup_corr_cuda(pyr, coords, r)
    copies = "16-byte" if cl.vec_launches > before else "4-byte"
    if (copies == "16-byte") != vec:
        fail(f"{tag}: K1 took the {copies} copies")
    out_p = cl.lookup_corr_plain(pyr, coords, r)
    max_err = float((out_k - out_p).abs().max())
    scale = float(pyr[0].abs().max())
    if not max_err <= 1e-5 * scale:
        fail(f"{tag}: max |K1 - plain| {max_err} > 1e-5 * max|corr| ({scale})")
    K2 = (2 * r + 1) ** 2
    n_off = 0
    for lvl, c in enumerate(pyr):
        Hl, Wl = c.shape[-2:]
        pt = coords / 2 ** lvl
        off = (pt[..., 0] >= Wl + r) | (pt[..., 1] >= Hl + r) | (pt.amin(-1) < -(r + 1))
        n_off += int(off.sum())
        if not bool((out_k[..., lvl * K2:(lvl + 1) * K2][off] == 0).all()):
            fail(f"{tag}: level {lvl} windows off the map do not read exactly 0")

    ms = time_ms(lambda: cl.lookup_corr_cuda(pyr, coords, r))
    host = []
    for _ in range(5):             # host enqueue of one call, median of 5 x 20 calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            cl.lookup_corr_cuda(pyr, coords, r)
        host.append((time.perf_counter() - t0) / 20 * 1e3)
    torch.cuda.synchronize()
    host_ms = float(np.median(host))
    plain_ms = time_ms(lambda: cl.lookup_corr_plain(pyr, coords, r))

    # library yardstick: one F.grid_sample call per level (timed, never used)
    K = 2 * r + 1
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], -1)                            # [K, K, 2]
    grids, inputs = [], []
    for lvl, c in enumerate(pyr):
        Hl, Wl = c.shape[-2:]
        pts = coords.view(B * P, 1, 1, 2) / 2 ** lvl + delta       # [BP, K, K, 2]
        norm = torch.tensor([2.0 / (Wl - 1), 2.0 / (Hl - 1)], device=coords.device)
        grids.append(pts * norm - 1.0)
        inputs.append(c.view(B * P, 1, Hl, Wl))

    def library():
        return [F.grid_sample(x, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for x, gr in zip(inputs, grids)]

    out_l = torch.cat([o.view(B, P, K * K) for o in library()], -1)
    lib_err = float((out_l - out_p).abs().max())
    library_ms = time_ms(library)
    del grids, inputs, out_l

    # bound: this data's bytes (output, coords, in-map windows) over HBM
    # bandwidth, vs ~13 flops per output over the fp32 rate
    bytes_moved = cl.lookup_bytes([c.shape[-2:] for c in pyr], coords, r)
    n_out = B * P * len(pyr) * K2
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 13 * n_out / FP32_FLOPS * 1e3
    res = dict(max_abs_err=max_err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               bound_ms=max(bound_bytes_ms, bound_ops_ms),
               bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
               bytes=bytes_moved)
    log(f"[{tag}] corr_lookup B={B} P={P} levels={len(pyr)} r={r} ({copies} copies, "
        f"level 0 {pyr[0].shape[2]}x{pyr[0].shape[3]}): max|K1-plain| "
        f"{max_err:.3e} (max|corr| {scale:.3f}); {n_off} (pixel, level) windows off the "
        f"map read exactly 0; K1 {ms:.4f} ms (host enqueue {host_ms:.4f} ms/call), plain "
        f"{plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms (max|grid_sample-plain| {lib_err:.3e}); bound "
        f"{res['bound_ms']:.4f} ms ({bytes_moved / 1e6:.1f} MB, {res['bound_by']}) -> "
        f"{100 * res['bound_ms'] / ms:.1f}% of bound")
    return res


def phase_kernel(dev, B=8, H8=55, W8=128):
    """K1 vs plain at the main path's block shape on synthetic coordinates:
    10% far out of range, the rest uniform over the map and its border. The
    main path's widths take the 16-byte copies; the same at W8 - 1 (rows not
    16-byte aligned) holds the 4-byte copies against plain."""
    import torch

    from particlesfm_tpu_torch.models.raft import build_corr_pyramid

    D, r = 128, 4
    g = torch.Generator(device=dev).manual_seed(0)
    runs = []
    for w8, vec in ((W8, True), (W8 - 1, False)):
        P = H8 * w8
        f1 = torch.randn(B, D, H8, w8, generator=g, device=dev)
        f2 = torch.randn(B, D, H8, w8, generator=g, device=dev)
        pyr = build_corr_pyramid(f1, f2, 4)
        del f1, f2
        lo = torch.tensor([-2.0, -2.0], device=dev)
        hi = torch.tensor([w8 + 1.0, H8 + 1.0], device=dev)
        coords = lo + (hi - lo) * torch.rand(B, P, 2, generator=g, device=dev)
        far = torch.rand(B, P, generator=g, device=dev) < 0.1
        sign = torch.where(torch.rand(B, P, 1, generator=g, device=dev) < 0.5, 1.0, -1.0)
        coords = torch.where(far[..., None], sign * torch.tensor([1000.0, -1000.0], device=dev),
                             coords).contiguous()
        runs.append(measure_lookup("kernel" if vec else "kernel-4B", pyr, coords, r, vec))
    return runs[0]


def profile_pipeline(dev, img_dir: Path, cfg) -> None:
    """One more run_pipeline under torch.profiler: device time by kernel and
    the device's busy share of the run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from particlesfm_tpu_torch.pipeline import run as R

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        R.run_pipeline(img_dir, WORK / "out_profiled", cfg, log=lambda *a: None, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"[profile] run_pipeline {wall:.2f}s wall (profiled), device kernels "
        f"{busy:.2f}s = {100 * busy / wall:.1f}% busy")
    for e in rows[:20]:
        log(f"[profile] {e.self_device_time_total / 1e3:10.1f} ms  x{e.count:<6} "
            f"{e.key[:100]}")
    for e in rows:
        if "corr_lookup_kernel" in e.key:
            log(f"[profile] K1 in run_pipeline: {e.count} launches, "
                f"{e.self_device_time_total / 1e3 / max(e.count, 1):.4f} ms device time each")


def check_selfcal(out_dir: Path, msgs, flows, gt_focal: float) -> dict:
    """selfcal.json of the run: interior and within 6% of the renderer's
    focal. The card's estimate from the run's flows against the CPU's, with
    the same injected RANSAC draws (the reference's): within 1e-3. Returns
    the card's correspondences, the draws and both focals for --dump."""
    from particlesfm_tpu_torch.globalsfm import selfcal

    p = out_dir / "selfcal.json"
    if not p.exists():
        fail("selfcal: the flow stage wrote no selfcal.json")
    info = json.loads(p.read_text())
    secs = next(float(m.split("selfcal: ")[1].rstrip("s")) for m in msgs
                if m.startswith("[flow] selfcal:"))
    miss = info["focal"] / gt_focal - 1
    log(f"[selfcal] focal {info['focal']:.2f} px (renderer {gt_focal:.2f} px, "
        f"{100 * miss:+.2f}%), confidence {info['confidence']:.3f}, dip "
        f"{info['dip']:.4f}, num_pairs {info['num_pairs']}, interior "
        f"{info['interior']}; {secs:.3f}s in the flow stage")
    if not info["interior"]:
        fail("selfcal: the focal is a boundary minimum (interior false)")
    if not abs(miss) <= 0.06:
        fail(f"selfcal: focal {info['focal']} misses the renderer's {gt_focal} by "
             f"{100 * miss:+.2f}% (> 6%)")

    ff = {k: flows[k] for k in ("flow_f", "flow_b")}
    # the draws the reference makes under PRNGKey(0), so that --dump lets
    # the JAX package run on the same correspondences with the same draws
    u_f, u_h = selfcal.reference_draws(0, selfcal.num_selfcal_pairs(ff["flow_f"].shape[0]))
    H, W = ff["flow_f"].shape[1:3]
    t0 = time.perf_counter()
    card = selfcal.estimate_focal_from_flows(ff, H, W, u_f=u_f, u_h=u_h)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = selfcal.estimate_focal_from_flows({k: v.cpu() for k, v in ff.items()}, H, W,
                                            u_f=u_f, u_h=u_h)
    t_cpu = time.perf_counter() - t0
    rel = card["focal"] / cpu["focal"] - 1
    log(f"[selfcal] card vs CPU, the reference's draws: focal {card['focal']:.3f} / "
        f"{cpu['focal']:.3f} px ({rel:+.2e}), confidence {card['confidence']:.3f} / "
        f"{cpu['confidence']:.3f}, num_pairs {card['num_pairs']} / {cpu['num_pairs']}; "
        f"{t_card:.3f}s / {t_cpu:.3f}s")
    if not abs(rel) <= 1e-3:
        fail(f"selfcal: card focal {card['focal']} vs CPU {cpu['focal']} ({rel:+.2e}) "
             "differ by more than 1e-3")
    uv1, uv2, ok = (x.cpu().numpy() for x in selfcal.flow_correspondences(ff, H, W))
    return dict(sc_uv1=uv1, sc_uv2=uv2, sc_ok=ok, sc_u_f=u_f.numpy(), sc_u_h=u_h.numpy(),
                sc_hw=np.array([H, W]), sc_focal_card=np.float64(card["focal"]),
                sc_conf_card=np.float64(card["confidence"]),
                sc_pairs_card=np.int64(card["num_pairs"]), sc_focal_run=np.float64(info["focal"]))


def check_depth(dev, cfg, depths, img_dir: Path, gt_inv_depth) -> dict:
    """48 finite frames each spanning exactly [0, 1]; the run's depth apply
    (`_load_depth_apply`: blocks of 4 frames, float16 rounding) on the card
    against the CPU on the first block of 4 full frames: normalized depth
    before the rounding within 1e-3, and the card's rounded output against
    the run's own depth of those frames; Pearson correlation with GT."""
    import torch

    from particlesfm_tpu_torch.io.images import load_image_stack
    from particlesfm_tpu_torch.models import depth as depth_mod
    from particlesfm_tpu_torch.pipeline.run import _load_depth_apply
    from particlesfm_tpu_torch.pipeline.stages import upload_frame_stack

    if depths.shape[0] != FRAMES or not bool(torch.isfinite(depths).all()):
        fail(f"depth: {depths.shape[0]} frames, finite {bool(torch.isfinite(depths).all())}")
    lo, hi = depths.amin(dim=(1, 2)), depths.amax(dim=(1, 2))
    if not (bool((lo == 0).all()) and bool((hi == 1).all())):
        fail(f"depth: per-frame min {lo.min()}..{lo.max()}, max {hi.min()}..{hi.max()}")
    n = 4
    images, _ = load_image_stack(img_dir)
    stack = upload_frame_stack(images[:n], "cpu")
    # the apply binds normalize_depth when it is built: wrap it to keep the
    # normalized depth before the float16 rounding
    orig, raw, rounded = depth_mod.normalize_depth, [], []     # card, CPU
    try:
        for d in (dev, torch.device("cpu")):
            kept = []
            depth_mod.normalize_depth = lambda x, kept=kept: kept.append(orig(x)) or kept[-1]
            rounded.append(_load_depth_apply(cfg, d)(stack.to(d)).cpu())
            raw.append(torch.cat(kept).cpu())
    finally:
        depth_mod.normalize_depth = orig
    diff = float((raw[0] - raw[1]).abs().max())
    vs_run = float((rounded[0] - depths[:n].cpu()).abs().max())
    pred = depths[:GT_PAIRS].reshape(GT_PAIRS, -1).double().cpu().numpy()
    gt = gt_inv_depth.reshape(GT_PAIRS, -1)
    r = np.mean([np.corrcoef(p, g)[0, 1] for p, g in zip(pred, gt)])
    log(f"[depth] {depths.shape[0]} frames at {depths.shape[2]}x{depths.shape[1]}, each "
        f"in [0, 1]; the run's depth apply, card vs CPU on a block of {n} frames: max "
        f"|diff| {diff:.3e} before the float16 rounding; card's rounded output vs the "
        f"run's depth: max |diff| {vs_run:.3e}; mean Pearson r with the renderer's "
        f"inverse depth over {GT_PAIRS} frames {r:.4f}")
    if not diff <= 1e-3:
        fail(f"depth: card vs CPU max |diff| {diff} > 1e-3")
    if not vs_run <= 2.0 ** -11:
        fail(f"depth: the apply's card output differs from the run's depth by {vs_run}")
    return dict(images=stack.numpy(), depth=depths.to(torch.float16).cpu().numpy())


def check_motionseg(dev, cfg, out_dir: Path, msgs, tracks, depths, gt_dynamic) -> dict:
    """The labeled tracks of a seg stage that ran. The run's seg apply on
    the card against the CPU on the first and the last (zero-padded) chunk
    of the run's own model input (every window, as `segment_tracks` samples
    and chunks it): logits within 1e-3, labels equal except where
    |logit| < 1e-3; the card's decisions on those chunks against the run's
    labels in the windows that share no frame. IoU of the dynamic tracks
    against the renderer's (majority vote per track)."""
    import torch

    from particlesfm_tpu_torch.motionseg.data import find_traj_label
    from particlesfm_tpu_torch.motionseg.infer import track_chunks, window_batch
    from particlesfm_tpu_torch.pipeline.run import _load_seg_apply
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    p = out_dir / "trajectories_labeled" / "tracks.npz"
    if not p.exists():
        fail("motionseg: no trajectories_labeled/tracks.npz")
    lab = TrackArrays.load(p)
    if lab.labels is None or lab.labels.shape != lab.mask.shape:
        fail("motionseg: the labeled tracks have no labels plane of the tracks' shape")
    if any("degrading to assume-static" in m for m in msgs):
        fail("motionseg: the pipeline degraded to assume-static")
    fwd = next(m for m in msgs if m.startswith("[motionseg] window-sample"))
    frac = float(lab.labels[lab.mask].mean())

    H, W = gt_dynamic.shape[1:]
    wins, samples, traj, valid = window_batch(
        tracks, (H, W), cfg.motionseg.window_size, cfg.motionseg.traj_max_num)
    chunks = track_chunks(traj, valid)
    width = chunks[0][0].shape[1]
    depth = depths[torch.as_tensor(np.stack(wins), device=depths.device)]
    apply = [_load_seg_apply(cfg, d) for d in (dev, torch.device("cpu"))]   # card, CPU
    thr = apply[0].threshold
    thr = cfg.motionseg.threshold if thr is None or abs(cfg.motionseg.threshold - 0.5) > 1e-9 \
        else thr
    frames_used = np.bincount(np.concatenate(wins))
    diff, flips, run_mismatch, checked, dump = 0.0, 0, 0, 0, {}
    picked = sorted({0, len(chunks) - 1})
    for c in picked:
        t, v = chunks[c]
        lg_card = apply[0](t, depth, v)
        lg = [lg_card.cpu().numpy(), apply[1](t, depth.cpu(), v).cpu().numpy()]
        diff = max(diff, float(np.abs(lg[0] - lg[1]).max()))
        flips += int(((lg[0] > 0) != (lg[1] > 0))[np.abs(lg[1]) >= 1e-3].sum())
        dyn = (torch.sigmoid(lg_card) > thr).cpu().numpy()
        for b, (win, (_locs, present, rows)) in enumerate(zip(wins, samples)):
            if (frames_used[win] > 1).any():
                continue          # labels there merge two windows
            sel = np.arange(c * width, min(len(rows), (c + 1) * width))
            got = lab.labels[rows[sel][:, None], win[None, :]]
            wrong = ((got != dyn[b, sel - c * width][:, None]) & present[sel]).any(1)
            run_mismatch += int((wrong & (np.abs(lg[0][b, sel - c * width]) >= 1e-3)).sum())
            checked += len(sel)
        dump.update({f"seg_traj_{c}": t, f"seg_valid_{c}": v, f"seg_logits_{c}": lg[0]})
    real_last = int(chunks[-1][1].any(-1).sum())

    gt = find_traj_label(lab.xy, lab.mask, gt_dynamic) > 0.5
    pred = (lab.labels * lab.mask).sum(1) > 0.5 * np.maximum(lab.mask.sum(1), 1)
    iou = (pred & gt).sum() / max((pred | gt).sum(), 1)
    log(f"[motionseg] {lab.num_tracks} labeled tracks, dynamic fraction of observations "
        f"{frac:.4f}; {fwd.split('[motionseg] ')[1]}; seg apply card vs CPU on chunks "
        f"{picked} of {len(chunks)} ({len(wins)} windows x {width} "
        f"slots each; the last holds {real_last} sampled tracks and "
        f"{len(wins) * width - real_last} padded slots): max |logit diff| {diff:.3e}, "
        f"{flips} label flips away from the decision; the card's decisions vs the run's "
        f"labels on {checked} tracks of the windows that share no frame: {run_mismatch} "
        f"differ; dynamic-track IoU against the renderer {iou:.4f} "
        f"({int(pred.sum())} predicted, {int(gt.sum())} GT dynamic tracks)")
    if not diff <= 1e-3:
        fail(f"motionseg: card vs CPU logits differ by {diff} > 1e-3")
    if flips:
        fail(f"motionseg: {flips} labels differ between card and CPU with |logit| >= 1e-3")
    if run_mismatch or not checked:
        fail(f"motionseg: {run_mismatch} of {checked} checked tracks carry labels other "
             "than the seg apply's decisions on the run's chunks")
    dump.update(seg_wins=np.stack(wins), seg_chunks=np.array(picked))
    return dump


class SolverLog:
    """Wraps the SfM stage's solvers for the timed run: the seconds of every
    call (a device synchronize on each side) and the first and the last
    call's arguments and result, kept on the card for the card-vs-CPU
    checks. `targets`: (module, function names) pairs; by default the
    global mapper's solvers and the model writers."""
    TIMED = ("build_pair_tensors", "upload_tracks_u16", "pair_draws", "threefry_uniform",
             "estimate_relative_poses", "full_epipolar_votes", "classify_two_view",
             "average_rotations", "build_observations", "build_obs_device",
             "refine_pairwise_translations", "triplet_baseline_constraints",
             "estimate_positions_lud", "triangulate_tracks", "filter_observations",
             "bundle_adjust", "estimate_pose_pnp")
    INCREMENTAL = ("build_pair_tensors", "pair_draws", "threefry_uniform",
                   "estimate_relative_poses", "track_inlier_stats",
                   "geometric_dynamic_track_filter", "build_observations",
                   "triangulate_tracks", "filter_observations", "bundle_adjust",
                   "estimate_pose_pnp")

    def __init__(self, targets=None):
        from particlesfm_tpu_torch.pipeline import stages
        from particlesfm_tpu_torch.sfm import mapper

        if targets is None:
            targets = [(mapper, self.TIMED),
                       (stages, ("write_models", "write_converted_outputs"))]
        self.first, self.last, self.secs, self.count, self._orig = {}, {}, {}, {}, []
        for mod, names in targets:
            for name in names:
                self._wrap(mod, name)

    def _wrap(self, mod, name):
        import torch

        fn = getattr(mod, name)
        self._orig.append((mod, name, fn))

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.secs[name] = self.secs.get(name, 0.0) + time.perf_counter() - t0
            self.count[name] = self.count.get(name, 0) + 1
            self.first.setdefault(name, (a, kw, out))
            self.last[name] = (a, kw, out)
            return out
        setattr(mod, name, timed)

    def restore(self):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def _to_cpu(x):
    """Tensors (in tuples, named tuples, lists and dicts) moved to the CPU."""
    import torch

    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _rot_angles(Ra, Rb) -> np.ndarray:
    """Angles (rad) between rotation batches, in float64 from the
    antisymmetric part (arccos of the trace cannot resolve 1e-4 in float32)."""
    M = np.asarray(Ra, np.float64) @ np.swapaxes(np.asarray(Rb, np.float64), -1, -2)
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.arctan2(0.5 * np.linalg.norm(v, axis=-1), 0.5 * (np.trace(M, axis1=1, axis2=2) - 1))


def check_sfm_solvers(cfg, solvers: SolverLog) -> None:
    """The first two-view, rotation-averaging, LUD and BA call of the run,
    repeated on the card and on the CPU from the run's own inputs: the same
    verified pairs and inlier counts equal on >= 99% of pairs; rotations
    within 1e-4 rad; positions within 1e-4 of their spread after Sim3; BA's
    final cost within 1e-4 relative. The card's repeat must equal the run's
    own result exactly (no atomic sum on these paths)."""
    import torch

    from particlesfm_tpu_torch.geometry.alignment import ate_rmse
    from particlesfm_tpu_torch.sfm import mapper

    def both(name):
        a, kw, out = solvers.first[name]
        fn = getattr(mapper, name)
        t0 = time.perf_counter()
        card = fn(*a, **kw)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = fn(*_to_cpu(a), **_to_cpu(kw))
        return a, out, card, cpu, t_card, time.perf_counter() - t0

    a, out, card, cpu, tc, tp = both("estimate_relative_poses")
    pmask = a[2].cpu().numpy()
    n_c, n_p = card.num_inliers.cpu().numpy(), cpu.num_inliers.numpy()
    v_c, v_p = (mapper._verified(n, pmask, cfg.sfm) for n in (n_c, n_p))
    eq = float((n_c == n_p).mean())
    rerun_same = bool(torch.equal(card.inliers, out.inliers))
    log(f"[sfm] card vs CPU, two-view RANSAC on the run's {len(n_c)} pairs (the reference's "
        f"draws): verified {int(v_c.sum())} / {int(v_p.sum())}, same set {bool((v_c == v_p).all())}, "
        f"inlier counts equal on {100 * eq:.2f}% of pairs (max |diff| "
        f"{int(np.abs(n_c.astype(int) - n_p).max())}); card repeat equals the run: "
        f"{rerun_same}; {tc:.3f}s / {tp:.3f}s")
    if not (v_c == v_p).all() or eq < 0.99:
        fail("sfm: two-view card vs CPU: verified sets differ or < 99% equal inlier counts")
    if not rerun_same:
        fail("sfm: the card's two-view repeat differs from the run's")

    a, out, card, cpu, tc, tp = both("average_rotations")
    ang = _rot_angles(card[0].cpu().numpy(), cpu[0].numpy())
    rerun_same = bool(torch.equal(card[0], out[0]))
    log(f"[sfm] card vs CPU, rotation averaging on the run's {a[0]} views x "
        f"{a[1].shape[0]} pairs: max angle {ang.max():.3e} rad, iterations "
        f"{card[1]['l1_iters']}+{card[1]['irls_iters']} / {cpu[1]['l1_iters']}+"
        f"{cpu[1]['irls_iters']}; card repeat equals the run: {rerun_same}; "
        f"{tc:.3f}s / {tp:.3f}s")
    if not ang.max() <= 1e-4:
        fail(f"sfm: rotation averaging card vs CPU differ by {ang.max()} rad > 1e-4")
    if not rerun_same:
        fail("sfm: the card's rotation-averaging repeat differs from the run's")

    a, out, card, cpu, tc, tp = both("estimate_positions_lud")
    pc, pp = card[0].cpu().numpy(), cpu[0].numpy()
    spread = float(np.linalg.norm(pp - pp.mean(0), axis=1).mean())
    ate = float(ate_rmse(pc, pp))
    rerun_same = bool(torch.equal(card[0], out[0]))
    log(f"[sfm] card vs CPU, LUD on the run's view graph ({a[0]} views, {a[1].shape[0]} "
        f"edge rows): Sim3 ATE "
        f"{ate:.3e} = {ate / max(spread, 1e-30):.3e} of the spread, ADMM iterations "
        f"{card[2]['iters']} / {cpu[2]['iters']}; card repeat equals the run: {rerun_same}; "
        f"{tc:.3f}s / {tp:.3f}s")
    if not ate <= 1e-4 * spread:
        fail(f"sfm: LUD card vs CPU Sim3 ATE {ate} > 1e-4 of the spread {spread}")
    if not rerun_same:
        fail("sfm: the card's LUD repeat differs from the run's")

    a, out, card, cpu, tc, tp = both("bundle_adjust")
    c_c, c_p = float(card.cost), float(cpu.cost)
    rel = abs(c_c - c_p) / max(abs(c_p), 1e-30)
    rerun_same = bool(torch.equal(card.q, out.q) and torch.equal(card.X, out.X))
    log(f"[sfm] card vs CPU, the run's first bundle_adjust ({a[0].shape[0]} views, "
        f"{a[3].shape[0]} tracks): final cost {c_c:.6e} / {c_p:.6e} ({rel:.2e} relative), "
        f"LM iterations {card.iters} / {cpu.iters}; card repeat equals the run: "
        f"{rerun_same}; {tc:.3f}s / {tp:.3f}s")
    if not rel <= 1e-4:
        fail(f"sfm: BA card vs CPU final cost differs by {rel:.2e} relative > 1e-4")
    if not rerun_same:
        fail("sfm: the card's BA repeat differs from the run's")


def check_sfm(dev, cfg, out_dir: Path, msgs, rec, gt, solvers: SolverLog, sfm_s: float,
              sfm_gb: float, dump: bool = False) -> dict:
    """The SfM stage's products: the model bins read back through the port's
    reader, the converted poses against the renderer's (>= 44 of 48 frames,
    Sim3 ATE <= 0.02), the native library, the solvers card vs CPU, and the
    stage repeated on the card from the run's labeled tracks under
    torch.profiler (the same registered frames, poses within 1e-6). With
    `dump`, the stage also runs on a seeded subset of SFM_DUMP_TRACKS labeled
    tracks, which is saved beside the dump with selfcal.json: the full set
    (~150 MB) exceeds what a run may bring back, and a full-size JAX run is
    not for a CPU host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from particlesfm_tpu_torch import native
    from particlesfm_tpu_torch.eval.pose_eval import evaluate_sequence, load_pose_dir
    from particlesfm_tpu_torch.io import colmap_model as cm
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    if not native.available():
        fail("sfm: the native host library (native/libparticlesfm_host.so) did not load")
    model = out_dir / "sfm" / "model"
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        if not (model / name).exists():
            fail(f"sfm: no sfm/model/{name}")
    cams, images, points = cm.read_model_binary(model)
    est = load_pose_dir(out_dir / "colmap_outputs_converted" / "poses")
    if not (out_dir / "sfm" / "stats.txt").exists():
        fail("sfm: no sfm/stats.txt")
    T = len(gt["w2c"])
    n_reg = rec.num_registered
    if len(images) != n_reg or len(est) != n_reg:
        fail(f"sfm: {len(images)} images in images.bin and {len(est)} converted poses for "
             f"{n_reg} registered frames")
    res = evaluate_sequence(est, {f"{i:06d}": gt["w2c"][i] for i in range(T)}, "seq_03_dyn")
    focal = float(rec.params[0])
    rounds = sum(m.startswith("[mapper] phase") for m in msgs)
    starts = 2 if any("multi-start with loop-consistency gate" in m for m in msgs) else 1
    retries = [m.split("] ", 1)[1] for m in msgs
               if "retrying with glomap" in m or "trying the complement" in m]
    n_models = sum(m.startswith("[manager] model") for m in msgs)
    lm = [int(m.split("lm-iters=")[1]) for m in msgs if "lm-iters=" in m]
    layers = {k: (round(v, 4), solvers.count[k]) for k, v in sorted(
        solvers.secs.items(), key=lambda kv: -kv[1])}
    replay = solvers.secs.get("pair_draws", 0.0) + solvers.secs.get("threefry_uniform", 0.0)
    log(f"[sfm] stage {sfm_s:.3f}s, peak {sfm_gb:.3f} GB above resident; {n_reg}/{T} frames "
        f"registered, {len(points)} points, {n_models} model(s); Sim3 ATE {res.ate:.5f}, "
        f"RPE-t {res.rpe_trans:.5f}, RPE-r {res.rpe_rot_deg:.4f} deg against the renderer; "
        f"focal {focal:.2f} px (renderer {gt['focal']:.2f} px, "
        f"{100 * (focal / gt['focal'] - 1):+.2f}%); {rounds} BA rounds (LM iterations "
        f"{lm}); start(s) {starts}, retries {retries or 'none'}; native host library loaded")
    for m in msgs:
        if m.startswith(("[sfm]", "[mapper]", "[manager]")):
            log(f"[sfm-log] {m}")
    log(f"[sfm] seconds (calls) by solver, device-synchronized: {json.dumps(layers)}; "
        f"threefry draw replay on the host {replay:.4f}s")
    if n_reg < 44:
        fail(f"sfm: {n_reg} of {T} frames registered (< 44)")
    if res.failed or not res.ate <= 0.02:
        fail(f"sfm: Sim3 ATE {res.ate} against the renderer's poses > 0.02")
    check_sfm_solvers(cfg, solvers)

    # run to run: the stage again from the run's own labeled tracks and selfcal.json
    rerun = WORK / "sfm_rerun"
    rerun.mkdir(parents=True, exist_ok=True)
    shutil.copy(out_dir / "selfcal.json", rerun / "selfcal.json")
    lab = TrackArrays.load(out_dir / "trajectories_labeled" / "tracks.npz")
    H, W = gt["dynamic"].shape[1:]
    names = [f"{i:06d}.ppm" for i in range(T)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec2 = stages.sfm_stage(lab, H, W, rerun, cfg, dev, names, log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ev if e.device_type == DeviceType.CUDA) / 1e6
    syncs = {k: sum(e.count for e in ev if e.key == k) for k in
             ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")}
    top = sorted((e for e in ev if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:8]
    dq = float(np.abs(rec2.qvec - rec.qvec).max())
    dt = float(np.abs(rec2.tvec - rec.tvec).max())
    same = bool((rec2.registered == rec.registered).all())
    log(f"[sfm] run to run: the stage again from the run's labeled tracks.npz and "
        f"selfcal.json: same registered frames {same}, max |dq| {dq:.3e}, max |dt| "
        f"{dt:.3e}; {wall:.3f}s wall under torch.profiler, device kernels {busy:.3f}s = "
        f"{100 * busy / wall:.1f}% busy; host syncs {json.dumps(syncs)}")
    for e in top:
        log(f"[sfm-profile] {e.self_device_time_total / 1e3:10.1f} ms  x{e.count:<6} "
            f"{e.key[:90]}")
    if not same or not (dq <= 1e-6 and dt <= 1e-6):
        fail("sfm: the repeated stage registered other frames or moved poses by > 1e-6")
    out = dict(sfm_gt_w2c=gt["w2c"], sfm_registered=rec.registered, sfm_qvec=rec.qvec,
               sfm_tvec=rec.tvec, sfm_params=rec.params, sfm_hw=np.array([H, W]),
               sfm_gt_focal=np.float64(gt["focal"]))
    if dump:
        rows = np.sort(np.random.default_rng(0).choice(lab.num_tracks, SFM_DUMP_TRACKS,
                                                       replace=False))
        sub = TrackArrays(xy=lab.xy[rows], mask=lab.mask[rows], labels=lab.labels[rows])
        sub_dir = WORK / "sfm_subset"
        sub_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(out_dir / "selfcal.json", sub_dir / "selfcal.json")
        sub.save(sub_dir / "tracks.npz")
        r = stages.sfm_stage(sub, H, W, sub_dir, cfg, dev, names, log=lambda *a: None)
        log(f"[sfm] --dump: {SFM_DUMP_TRACKS} of {lab.num_tracks} labeled tracks (seed 0): "
            f"{r.num_registered}/{T} registered on the card")
        out.update(sfm_sub_registered=r.registered, sfm_sub_qvec=r.qvec, sfm_sub_tvec=r.tvec,
                   sfm_sub_params=r.params)
    return out


def phase_slice(dev, frames: int, profile_run: bool = False, dump: bool = False):
    import torch

    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages

    img_dir = WORK / "images"
    out_dir = WORK / "out"
    t0 = time.perf_counter()
    gt = render_sequence(frames, img_dir)
    log(f"[slice] rendered seq_03_dyn seed 0: {frames} frames at "
        f"{SEQ['w']}x{SEQ['h']} in {time.perf_counter() - t0:.1f}s (host pool)")

    args = R.build_arg_parser().parse_args([
        "--image_dir", str(img_dir), "--output_dir", str(out_dir)])
    cfg = R.config_from_args(args)
    msgs = []
    kept, stage_gb, peak = {}, {}, [0]
    names = ("flow_stage", "tracking_stage", "depth_stage", "motionseg_stage", "sfm_stage")
    originals = {n: getattr(stages, n) for n in names}

    def measured(name, fn):
        """Keep the stage's result (tensors on the card, checked after the
        timed run; the run itself writes no .flo files or depth PNGs) and its
        peak allocation above what was resident when it started."""
        def run_stage(*a, **kw):
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kept[name] = fn(*a, **kw)
            stage_gb[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
            return kept[name]
        return run_stage

    for n in names:
        setattr(stages, n, measured(n, originals[n]))
    solvers = SolverLog()
    try:
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        cl.reset_launches()
        t0 = time.perf_counter()
        R.run_pipeline(img_dir, out_dir, cfg, log=msgs.append, device=dev)
        wall = time.perf_counter() - t0
        launches, vec_launches = cl.launches, cl.vec_launches
    finally:
        for n in names:
            setattr(stages, n, originals[n])
        solvers.restore()
    peak_gb = (max(peak[0], torch.cuda.max_memory_allocated()) - resident) / 1e9
    flows, tracks = kept["flow_stage"], kept["tracking_stage"]

    n_pairs = 2 * (frames - 1) + 2 * (frames - 2)
    blocks = math.ceil(n_pairs / cfg.flow.per_device)
    if launches != blocks * cfg.flow.iters:
        fail(f"slice: K1 launched {launches} times, expected {blocks} blocks x "
             f"{cfg.flow.iters} iterations")
    if vec_launches != launches:
        fail(f"slice: {launches - vec_launches} of {launches} K1 launches took 4-byte copies")
    for name in ("flow_f", "flow_b", "flow_f2", "flow_b2"):
        if not bool(torch.isfinite(flows[name]).all()):
            fail(f"slice: non-finite values in {name}")
    epe = np.linalg.norm(flows["flow_f"][:GT_PAIRS].cpu().numpy() - gt["flow"], axis=-1)
    epe_median = float(np.median(epe))
    epe_mean_pairs = [float(e.mean()) for e in epe]
    if not epe_median <= 1.0:
        fail(f"slice: median stride-1 EPE {epe_median} px > 1.0")
    n_long = int((tracks.lengths >= 3).sum())
    if n_long < 10_000:
        fail(f"slice: {n_long} tracks of length >= 3 (< 10000)")
    net_s = next(float(m.split("net+refine: ")[1].split("s")[0])
                 for m in msgs if "net+refine:" in m)
    timings = (out_dir / "timings.txt").read_text().strip().splitlines()
    stage_s = {ln.split()[0]: float(ln.split()[1].rstrip("s")) for ln in timings[1:]}
    for stage in ("frame_upload", "flow", "trajectories", "depth", "motion_seg", "sfm"):
        if stage not in stage_s:
            fail(f"slice: no '{stage}' stage in timings.txt")
    log(f"[slice] run_pipeline {wall:.2f}s: stages {json.dumps(stage_s)}; "
        f"{n_pairs} pairs in {blocks} blocks, net+refine {net_s:.3f}s = "
        f"{n_pairs / net_s:.2f} pairs/s; K1 launches {launches} ({vec_launches} with "
        f"16-byte copies); "
        f"stride-1 EPE median {epe_median:.4f} px, per-pair mean "
        f"{np.round(epe_mean_pairs, 4).tolist()}; {n_long} tracks of length >= 3 "
        f"over {tracks.num_frames} frames; peak allocated {peak_gb:.2f} GB (each stage's "
        f"own: {json.dumps({k: round(v, 3) for k, v in stage_gb.items()})})")
    dump_on = dump
    dump = check_selfcal(out_dir, msgs, flows, gt["focal"])
    dump.update(check_depth(dev, cfg, kept["depth_stage"], img_dir, gt["inv_depth"]))
    dump.update(check_motionseg(dev, cfg, out_dir, msgs, tracks, kept["depth_stage"],
                                gt["dynamic"]))
    dump.update(check_sfm(dev, cfg, out_dir, msgs, kept["sfm_stage"], gt, solvers,
                          stage_s["sfm"], stage_gb["sfm_stage"], dump_on))
    if profile_run:
        profile_pipeline(dev, img_dir, cfg)
    return dict(launches=launches, img_dir=img_dir, dump=dump, gt=gt, out_dir=out_dir,
                last_ba=solvers.last["bundle_adjust"])


def _pose_eval(out_dir: Path, gt):
    """The run's converted poses against the renderer's, over the frames
    the run registered (Sim3 ATE, RPE between consecutive registered ones)."""
    from particlesfm_tpu_torch.eval.pose_eval import evaluate_sequence, load_pose_dir

    est = load_pose_dir(out_dir / "colmap_outputs_converted" / "poses")
    T = len(gt["w2c"])
    return est, evaluate_sequence(est, {f"{i:06d}": gt["w2c"][i] for i in range(T)},
                                  "seq_03_dyn", min_registered_ratio=0.0)


def _registration_order(msgs):
    return [int(m.split("registered image ")[1].split()[0]) for m in msgs
            if m.startswith("[incremental] registered image")]


def _stage_dir(name: str, src: Path) -> Path:
    """A fresh output directory holding `src`'s selfcal.json (the focal prior)."""
    d = WORK / name
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "selfcal.json", d / "selfcal.json")
    return d


def modes_incremental(dev, img_dir: Path, gt) -> dict:
    """(a) `--sfm_type incremental` as the user's command, then its checks."""
    import torch

    from particlesfm_tpu_torch.io import colmap_model as cm
    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.sfm import incremental
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    out_dir = WORK / "out_incremental"
    cfg = R.config_from_args(R.build_arg_parser().parse_args([
        "--image_dir", str(img_dir), "--output_dir", str(out_dir), "--sfm_type", "incremental"]))
    msgs = []
    solvers = SolverLog([(incremental, SolverLog.INCREMENTAL),
                         (stages, ("write_colmap_model", "write_converted_outputs"))])
    try:
        cl.reset_launches()
        t0 = time.perf_counter()
        rec = R.run_pipeline(img_dir, out_dir, cfg, log=msgs.append, device=dev)
        wall = time.perf_counter() - t0
        launches, vec_launches = cl.launches, cl.vec_launches
    finally:
        solvers.restore()
    T = len(gt["w2c"])
    blocks = math.ceil((2 * (T - 1) + 2 * (T - 2)) / cfg.flow.per_device)
    if launches != blocks * cfg.flow.iters or vec_launches != launches:
        fail(f"modes: incremental run launched K1 {launches} times ({vec_launches} 16-byte), "
             f"expected {blocks * cfg.flow.iters}, all 16-byte")
    for m in msgs:
        if m.startswith(("[sfm]", "[incremental]")) and "registered image" not in m:
            log(f"[modes-log] {m}")
    timings = (out_dir / "timings.txt").read_text().strip().splitlines()
    stage_s = {ln.split()[0]: float(ln.split()[1].rstrip("s")) for ln in timings[1:]}
    n_reg = rec.num_registered
    if n_reg < 3:
        fail(f"modes: the incremental run registered {n_reg} frames (< 3)")
    if not (np.isfinite(rec.qvec[rec.registered]).all() and np.isfinite(rec.tvec[rec.registered]).all()):
        fail("modes: non-finite incremental poses")
    _, images, points = cm.read_model_binary(out_dir / "sfm" / "model")
    est, res = _pose_eval(out_dir, gt)
    if len(images) != n_reg or len(est) != n_reg or (out_dir / "sfm" / "model" / "0").exists():
        fail(f"modes: {len(images)} images in the model and {len(est)} converted poses for "
             f"{n_reg} registered frames (one model expected)")
    if not (out_dir / "sfm" / "stats.txt").read_text().startswith(f"Registered images: {n_reg}"):
        fail("modes: sfm/stats.txt does not report the registered count")
    order = _registration_order(msgs)
    focal = float(rec.params[0])
    layers = {k: (round(v, 4), solvers.count[k]) for k, v in sorted(
        solvers.secs.items(), key=lambda kv: -kv[1])}
    log(f"[modes] (a) run_pipeline --sfm_type incremental {wall:.2f}s: stages "
        f"{json.dumps(stage_s)}; K1 {launches} launches ({vec_launches} 16-byte); "
        f"{n_reg}/{T} frames registered {np.nonzero(rec.registered)[0].tolist()}, "
        f"{len(points)} points; over them Sim3 ATE {res.ate:.5f}, RPE-t "
        f"{res.rpe_trans:.5f}, RPE-r {res.rpe_rot_deg:.4f} deg against the renderer; "
        f"focal {focal:.2f} px (renderer {gt['focal']:.2f} px, "
        f"{100 * (focal / gt['focal'] - 1):+.2f}%); {solvers.count.get('bundle_adjust', 0)} BA "
        f"calls, {solvers.count.get('estimate_pose_pnp', 0)} PnP calls; registration order "
        f"{order}")
    log(f"[modes] (a) seconds (calls) by solver, device-synchronized: {json.dumps(layers)}")

    def both(name):
        a, kw, out = solvers.first[name]
        fn = getattr(incremental, name)
        t0 = time.perf_counter()
        card = fn(*a, **kw)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = fn(*_to_cpu(a), **_to_cpu(kw))
        return a, out, card, cpu, t_card, time.perf_counter() - t0

    a, out, card, cpu, tc, tp = both("estimate_pose_pnp")
    n = [int(x.num_inliers) for x in (out, card, cpu)]
    log(f"[modes] (a) card vs CPU, the first PnP registration ({int(a[2].sum())} 2D-3D pairs, "
        f"the reference's draws): inliers run {n[0]}, card {n[1]}, CPU {n[2]}; "
        f"{tc:.3f}s / {tp:.3f}s")
    if n[1] != n[2] or n[0] != n[1]:
        fail(f"modes: first PnP inlier counts run/card/CPU {n}")
    a, out, card, cpu, tc, tp = both("bundle_adjust")
    c_c, c_p = float(card.cost), float(cpu.cost)
    rel = abs(c_c - c_p) / max(abs(c_p), 1e-30)
    rerun_same = bool(torch.equal(card.q, out.q) and torch.equal(card.X, out.X))
    log(f"[modes] (a) card vs CPU, the first incremental BA ({a[0].shape[0]} views, "
        f"{a[3].shape[0]} tracks): final cost {c_c:.6e} / {c_p:.6e} ({rel:.2e} relative), LM "
        f"iterations {card.iters} / {cpu.iters}; card repeat equals the run: {rerun_same}; "
        f"{tc:.3f}s / {tp:.3f}s")
    if not rel <= 1e-4:
        fail(f"modes: first incremental BA card vs CPU cost differs by {rel:.2e} > 1e-4")

    # run to run: the incremental stage again from the run's own labeled tracks
    lab = TrackArrays.load(out_dir / "trajectories_labeled" / "tracks.npz")
    H, W = gt["dynamic"].shape[1:]
    names = [f"{i:06d}.ppm" for i in range(T)]
    msgs2 = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec2 = stages.sfm_stage(lab, H, W, _stage_dir("inc_rerun", out_dir), cfg, dev, names,
                            log=msgs2.append)
    torch.cuda.synchronize()
    t_rerun = time.perf_counter() - t0
    same_order = _registration_order(msgs2) == order
    bitwise = bool(np.array_equal(rec2.qvec, rec.qvec) and np.array_equal(rec2.tvec, rec.tvec)
                   and (rec2.registered == rec.registered).all())
    log(f"[modes] (a) run to run: the incremental stage again from the run's labeled tracks: "
        f"same registration order {same_order}, bit-identical poses {bitwise}; {t_rerun:.3f}s")
    if not (same_order and bitwise):
        fail("modes: the repeated incremental stage registered in another order or moved poses")
    # the last PnP call (the loop ends on a round where every candidate
    # fails): its inputs, for the JAX package's PnP in the --dump compare
    a, kw, out = solvers.last["estimate_pose_pnp"]
    return dict(inc_sfm_s=stage_s["sfm"], inc_registered=rec.registered, inc_qvec=rec.qvec,
                inc_tvec=rec.tvec, inc_params=rec.params, inc_order=np.array(order),
                inc_pnp_X=a[0].cpu().numpy(), inc_pnp_x=a[1].cpu().numpy(),
                inc_pnp_mask=a[2].cpu().numpy(), inc_pnp_thres=np.float64(a[3]),
                inc_pnp_u=kw["u"].cpu().numpy(), inc_pnp_inliers=np.int64(int(out.num_inliers)))


def modes_positions(dev, slice_out: Path, gt) -> None:
    """(b) The SfM stage with linear and with nonlinear positions on the
    default run's labeled tracks; each estimator card vs CPU."""
    import torch

    from particlesfm_tpu_torch.geometry.alignment import ate_rmse
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.sfm import mapper
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    lab = TrackArrays.load(slice_out / "trajectories_labeled" / "tracks.npz")
    T = len(gt["w2c"])
    H, W = gt["dynamic"].shape[1:]
    names = [f"{i:06d}.ppm" for i in range(T)]
    for method, fn_name in (("linear", "estimate_positions_linear"),
                            ("nonlinear", "refine_positions_nonlinear")):
        cfg = R.config_from_args(R.build_arg_parser().parse_args([
            "--image_dir", "-", "--output_dir", "-", "--set", f"sfm.position.method={method}"]))
        d = _stage_dir(f"sfm_{method}", slice_out)
        solvers = SolverLog([(mapper, (fn_name,))])
        msgs = []
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = stages.sfm_stage(lab, H, W, d, cfg, dev, names, log=msgs.append)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            solvers.restore()
        if fn_name not in solvers.first:
            fail(f"modes: the {method} stage never called {fn_name}")
        ate = _pose_eval(d, gt)[1].ate if rec.num_registered >= 3 else float("nan")
        a, kw, out = solvers.first[fn_name]
        fn = getattr(mapper, fn_name)
        t0 = time.perf_counter()
        card = fn(*a, **kw)
        torch.cuda.synchronize()
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = fn(*_to_cpu(a), **_to_cpu(kw))
        tp = time.perf_counter() - t0
        pc, pp = card.cpu().numpy(), cpu.numpy()
        spread = float(np.linalg.norm(pp - pp.mean(0), axis=1).mean())
        d_ate = float(ate_rmse(pc, pp))
        focal = float(rec.params[0])
        log(f"[modes] (b) {method} positions: SfM stage {secs:.3f}s, {rec.num_registered}/{T} "
            f"registered, Sim3 ATE {ate:.5f} against the renderer, focal {focal:.2f} px "
            f"({100 * (focal / gt['focal'] - 1):+.2f}%); {solvers.count[fn_name]} {fn_name} "
            f"call(s), {solvers.secs[fn_name]:.3f}s; card vs CPU on the first call's inputs "
            f"({a[0]} views, {a[1].shape[0]} edge rows): Sim3 ATE {d_ate:.3e} = "
            f"{d_ate / max(spread, 1e-30):.3e} of the spread; card repeat equals the run: "
            f"{bool(torch.equal(card, out))}; {tc:.3f}s / {tp:.3f}s")
        if not d_ate <= 1e-4 * spread:
            fail(f"modes: {method} positions card vs CPU Sim3 ATE {d_ate} > 1e-4 of {spread}")


def modes_pcg(last_ba) -> None:
    """(c) The default run's last BA problem with solver="pcg", card vs CPU."""
    import torch

    from particlesfm_tpu_torch.globalsfm.ba import bundle_adjust

    a, kw, dense = last_ba
    kw = dict(kw, solver="pcg")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = bundle_adjust(*a, **kw)
    torch.cuda.synchronize()
    tc = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = bundle_adjust(*_to_cpu(a), **_to_cpu(kw))
    tp = time.perf_counter() - t0
    c_c, c_p, c_d = float(card.cost), float(cpu.cost), float(dense.cost)
    rel = abs(c_c - c_p) / max(abs(c_p), 1e-30)
    log(f"[modes] (c) PCG on the default run's last BA problem ({a[0].shape[0]} views, "
        f"{a[3].shape[0]} tracks, 50 CG iterations per LM step): final cost card {c_c:.6e} / "
        f"CPU {c_p:.6e} ({rel:.2e} relative), LM iterations {card.iters} / {cpu.iters}; the "
        f"run's dense solve {c_d:.6e} ({dense.iters} LM iterations): PCG - dense "
        f"{(c_c - c_d) / c_d:+.3e} relative; {tc:.3f}s / {tp:.3f}s")
    if not rel <= 1e-4:
        fail(f"modes: PCG card vs CPU final cost differs by {rel:.2e} > 1e-4")


def modes_half_flow(dev, img_dir: Path, gt) -> dict:
    """(d) The flow stage at flow.infer_scale=0.5 with the stride-2
    composition fallback at 4 px; K1's launches, the flows, and the
    fallback card vs CPU on the run's own flows."""
    import torch

    from particlesfm_tpu_torch.io.images import load_image_stack
    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.ops.flow_ops import compose_flow
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages

    out_dir = WORK / "out_half"
    cfg = R.config_from_args(R.build_arg_parser().parse_args([
        "--image_dir", str(img_dir), "--output_dir", str(out_dir),
        "--set", "flow.infer_scale=0.5", "--set", "flow.stride2_compose_disagree_px=4.0"]))
    images, _ = load_image_stack(img_dir)
    apply = R._load_raft_apply(cfg, dev)
    stack = stages.upload_frame_stack(images, dev)
    out_dir.mkdir(parents=True)
    calls, msgs = [], []
    fallback = stages.stride2_compose_fallback

    def keep(*a, **kw):
        out = fallback(*a, **kw)
        calls.append((a, kw, out))
        return out
    stages.stride2_compose_fallback = keep
    try:
        cl.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows = stages.flow_stage(images, out_dir, cfg, dev, apply, device_stack=stack,
                                  log=msgs.append)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, vec_launches = cl.launches, cl.vec_launches
    finally:
        stages.stride2_compose_fallback = fallback
    T = images.shape[0]
    blocks = math.ceil((2 * (T - 1) + 2 * (T - 2)) / cfg.flow.per_device)
    if launches != blocks * cfg.flow.iters or vec_launches != launches:
        fail(f"modes: half-scale flow launched K1 {launches} times ({vec_launches} 16-byte), "
             f"expected {blocks * cfg.flow.iters}, all 16-byte")
    for name in ("flow_f", "flow_b", "flow_f2", "flow_b2"):
        if tuple(flows[name].shape[1:3]) != images.shape[1:3] or \
                not bool(torch.isfinite(flows[name]).all()):
            fail(f"modes: half-scale {name} not finite at the frames' size")
    epe = np.linalg.norm(flows["flow_f"][:GT_PAIRS].cpu().numpy() - gt["flow"], axis=-1)
    epe_median = float(np.median(epe))
    if not epe_median <= 2.0:
        fail(f"modes: half-scale median stride-1 EPE {epe_median} px > 2.0")
    if len(calls) != 2:
        fail(f"modes: the stride-2 fallback ran {len(calls)} times, expected 2")
    shares, worst_mask, worst_val = [], 0, 0.0
    tau = cfg.flow.stride2_compose_disagree_px
    t_cpu = 0.0
    for a, kw, (blend, used) in calls:
        t0 = time.perf_counter()
        blend_c, used_c = fallback(*_to_cpu(a), **_to_cpu(kw))
        t_cpu += time.perf_counter() - t0
        comp, _ = compose_flow(a[1].cpu(), a[2].cpu())
        gap = (torch.linalg.vector_norm(a[0].cpu() - comp, dim=-1) - tau).abs()
        differ = used.cpu() != used_c
        worst_mask += int((differ & (gap >= 1e-4)).sum())
        same = ~differ
        worst_val = max(worst_val, float((blend.cpu() - blend_c).abs()[same].max()))
        shares.append(float(used.float().mean()))
    log(f"[modes] (d) flow stage at infer_scale 0.5 with the 4 px stride-2 fallback "
        f"{secs:.3f}s: K1 {launches} launches ({vec_launches} 16-byte); stride-1 EPE median "
        f"{epe_median:.4f} px against the renderer; fallback share of pixels flow_f2 "
        f"{100 * shares[0]:.3f}%, flow_b2 {100 * shares[1]:.3f}%; card vs CPU on the run's "
        f"flows: {worst_mask} pixels with another fallback decision away from the threshold, "
        f"blended max |diff| {worst_val:.3e} px; CPU {t_cpu:.3f}s")
    if worst_mask or not worst_val <= 1e-5:
        fail(f"modes: fallback card vs CPU: {worst_mask} decisions differ, values {worst_val}")
    return dict(launches_half=launches)


def phase_modes(dev, s: dict, dump: bool) -> dict:
    """Phase 5: the other run_pipeline options on the slice's frames. With
    `dump`, the incremental, linear and nonlinear stages also run on the
    --dump track subset, whose poses go into the dump."""
    res = modes_incremental(dev, s["img_dir"], s["gt"])
    modes_positions(dev, s["out_dir"], s["gt"])
    modes_pcg(s["last_ba"])
    res.update(modes_half_flow(dev, s["img_dir"], s["gt"]))
    if dump:
        from particlesfm_tpu_torch.pipeline import run as R
        from particlesfm_tpu_torch.pipeline import stages
        from particlesfm_tpu_torch.tracks.store import TrackArrays

        sub = TrackArrays.load(WORK / "sfm_subset" / "tracks.npz")
        T = len(s["gt"]["w2c"])
        H, W = s["gt"]["dynamic"].shape[1:]
        names = [f"{i:06d}.ppm" for i in range(T)]
        for mode, extra in (("incremental", ["--sfm_type", "incremental"]),
                            ("linear", ["--set", "sfm.position.method=linear"]),
                            ("nonlinear", ["--set", "sfm.position.method=nonlinear"])):
            cfg = R.config_from_args(R.build_arg_parser().parse_args(
                ["--image_dir", "-", "--output_dir", "-", *extra]))
            r = stages.sfm_stage(sub, H, W, _stage_dir(f"sub_{mode}", WORK / "sfm_subset"),
                                 cfg, dev, names, log=lambda *a: None)
            log(f"[modes] --dump: {mode} on the {SFM_DUMP_TRACKS}-track subset: "
                f"{r.num_registered}/{T} registered on the card")
            s["dump"].update({f"sfm_sub_{mode}_registered": r.registered,
                              f"sfm_sub_{mode}_qvec": r.qvec, f"sfm_sub_{mode}_tvec": r.tvec,
                              f"sfm_sub_{mode}_params": r.params})
    return res


def phase_net(dev, img_dir: Path, scale: float = 1.0, tag: str = "kernel-net"):
    """One block through RAFT with K1 and with the plain lookup, at the
    pipeline's `scale` (`flow.infer_scale`): the flows must agree. K1 is
    then measured on the pyramid and the coordinates of the block's last GRU
    iteration (the net's own coordinates)."""
    import torch
    import torch.nn.functional as F

    from particlesfm_tpu_torch.flow.infer import _net_flow, load_model
    from particlesfm_tpu_torch.io.images import load_image_stack
    from particlesfm_tpu_torch.ops.corr_lookup import lookup_corr, lookup_corr_plain
    from particlesfm_tpu_torch.pipeline.run import DEFAULT_RAFT_CKPT

    images, _ = load_image_stack(img_dir)
    n = min(8, len(images) - 1)               # one block of stride-1 pairs
    x = torch.from_numpy(images[:n + 1]).to(dev).permute(0, 3, 1, 2)
    x = F.pad(x, (0, (-x.shape[-1]) % 8, 0, (-x.shape[-2]) % 8), mode="replicate")
    x = x.permute(0, 2, 3, 1).contiguous()
    model, _ = load_model(DEFAULT_RAFT_CKPT, dev)
    last = {}

    def keep_last(pyramid, pts, radius):
        last.update(pyramid=pyramid, coords=pts, radius=radius)
        return lookup_corr(pyramid, pts, radius)

    with torch.inference_mode():
        model.lookup = keep_last
        fk = _net_flow(model, x[:n], x[1:], 8, scale)
        model.lookup = lookup_corr_plain
        fp = _net_flow(model, x[:n], x[1:], 8, scale)
    d = (fk - fp).abs()
    mean_d, max_d = float(d.mean()), float(d.max())
    if not (mean_d <= 1e-3 and max_d <= 1e-2):
        fail(f"net: K1 vs plain flows differ by mean {mean_d} / max {max_d} px (scale {scale})")
    H8, W8 = last["pyramid"][0].shape[-2:]
    log(f"[net] RAFT block of {n} pairs, frames {x.shape[2]}x{x.shape[1]} at scale {scale} "
        f"(net input {8 * W8}x{8 * H8}): K1 vs plain lookup flow |diff| mean {mean_d:.3e} px, "
        f"max {max_d:.3e} px")
    del fk, fp, d
    with torch.inference_mode():
        return measure_lookup(tag, last["pyramid"], last["coords"], last["radius"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more pipeline run (device time by kernel)")
    ap.add_argument("--dump", metavar="DIR", default=None,
                    help="write the selfcal correspondences and draws, the slice's depth, "
                         "4 frames, the seg check's chunks and card logits and the SfM "
                         "stage's poses to DIR/slice_dump.npz, and a seeded subset of the "
                         "labeled tracks (tracks.npz, with the card's SfM poses on it in "
                         "the npz) and selfcal.json beside it, for "
                         "scripts/compare_chip_dump_with_jax.py")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import particlesfm_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from particlesfm_tpu_torch.ops import corr_lookup as cl

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    so = cl.load_library()
    log(f"[build] corr_lookup.cu -> {Path(so._name).name} in "
        f"{time.perf_counter() - t0:.2f}s")
    ptxas = Path(so._name).with_suffix(".log")
    if ptxas.exists():
        for ln in ptxas_lines(ptxas.read_text(), "corr_lookup_kernelILi4ELi4E"):
            log(f"[build] {ln}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
                fail("build: the r=4, 4-level kernel spills registers")

    k = phase_kernel(dev)
    if WORK.exists():
        shutil.rmtree(WORK)
    try:
        s = phase_slice(dev, FRAMES, args.profile, bool(args.dump))
        if args.dump:          # saved before [modes] too, so that its failure leaves the dump
            d = Path(args.dump)
            d.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(d / "slice_dump.npz", **s["dump"])
            for name in ("tracks.npz", "selfcal.json"):
                shutil.copy(WORK / "sfm_subset" / name, d / name)
        m = phase_modes(dev, s, bool(args.dump))
        if args.dump:
            s["dump"].update(m)
            np.savez_compressed(d / "slice_dump.npz", **s["dump"])
        kh = phase_net(dev, s["img_dir"], scale=0.5, tag="kernel-half")
        kn = phase_net(dev, s["img_dir"])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    kernels = [dict(
        name="corr_lookup", route="cuda",
        source="particlesfm_tpu_torch/csrc/corr_lookup.cu",
        replaces="particlesfm_tpu/ops/corr_lookup.py:62",
        launches=s["launches"], max_abs_err=k["max_abs_err"], ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
        library_ms=k["library_ms"], ms_net=kn["ms"], plain_ms_net=kn["plain_ms"],
        library_ms_net=kn["library_ms"], bound_ms_net=kn["bound_ms"],
        max_abs_err_net=kn["max_abs_err"], launches_half=m["launches_half"],
        ms_half=kh["ms"], plain_ms_half=kh["plain_ms"], library_ms_half=kh["library_ms"],
        bound_ms_half=kh["bound_ms"], max_abs_err_half=kh["max_abs_err"])]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
