"""Smoke run of the PyTorch/CUDA port on one GPU: builds kernel K1, holds it
against its plain version, drives the port's main path and checks its output.

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --dump DIR  # also the checks' inputs, for the JAX compare
                                      # (and a labeled-track subset + selfcal.json,
                                      # and [mesh]'s BA problem and 4-shard result)

Phases (each prints its lines; any failure exits non-zero):
  1. device  — CUDA required; card name and power limit from nvidia-smi.
  2. build   — nvcc builds csrc/corr_lookup.cu and csrc/track_lm.cu
               (sm_90a); the r=4, 4-level K1's and K2's `-Xptxas -v`
               registers and spills (a spill fails the run).
  3. kernel  — K1 vs the plain lookup at the main path's block shape
               (8 pairs, 55x128 level 0, 4 levels, r=4) on synthetic
               coordinates: max error, exact zeros off the map, times
               (kernel, plain, F.grid_sample) and the bound.
               [track_lm] K2, the tracker's refinement step, vs its plain
               torch ops on one 1024x436 frame state of 131,072 slots:
               slots moved by more than 1e-4 px (at most 1e-4 of the
               eligible), times (kernel, plain) and the byte and FLOP bound.
  4. slice   — renders the acceptance set's seq_03_dyn (seed 0, 1024x436,
               48 frames) and runs the user's default `run_pipeline` (global
               SfM included) on the card: K1 launch count, K2 launch count
               (one a flow from the second: 46), finite flows,
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
  5. mesh    — the device mesh on [slice]'s own data: make_mesh() covers
               every visible card; on a logical mesh of 4 x cuda:0
               (overhead and correctness, not scaling) and, with more than
               one card, on the real mesh: sharded_map_frames(occlusion_mask)
               on the run's 47 forward/backward pairs, the pipeline's flow
               apply on its first 32 pairs (the same K1 launch count), the
               depth apply on 8 frames and segment_tracks on the run's
               tracks equal the one-device results bit for bit (labels: the
               run's); sharded_bundle_adjust on [slice]'s last BA problem
               within the reference test's tolerances of plain BA (cost
               1e-3 relative, q 1e-4, t and X 1e-3); the same sharded BA in
               a world-size-1 NCCL group (its sums all-reduced on the card)
               bit-identical to the in-process one. Wall times against the
               one-device paths.
  6. modes   — every other run_pipeline option on the same frames:
               (a) `--sfm_type incremental` as the user's command: K1
                   launches, model and converted outputs, >= 3 registered
                   frames with finite poses; the first PnP registration,
                   every PnP call (equal inliers on the card's inputs) and
                   the first BA card vs CPU; the incremental stage repeated
                   (same registration order, bit-identical poses); the
                   incremental stage on a seeded 30,000-track subset of the
                   default run's labeled tracks on the card (every PnP call
                   card vs CPU) and on the CPU in a worker process: the same
                   registered frames;
               (b) `sfm.position.method=linear` and `=nonlinear` on the
                   default run's labeled tracks: each estimator card vs CPU;
               (c) the default run's last BA problem with solver="pcg",
                   card vs CPU, and its gap to the dense solve;
               (d) the flow stage with `flow.infer_scale=0.5` and
                   `flow.stride2_compose_disagree_px=4`: K1 at the 28x64
                   shape, finite flows, stride-1 EPE, the fallback card vs
                   CPU on the run's own flows; one block through RAFT with
                   K1 and with the plain lookup at 224x512 (`[kernel-half]`).
  7. net     — one block of 8 pairs through RAFT with K1 and with the plain
               lookup on the card; the flows must agree. `[kernel-net]`: the
               measurements of phase 3 on the pyramid and coordinates of the
               block's last GRU iteration (the net's own coordinates).
  8. train   — the three trainers at their default configurations on small
               in-process renders: for each, one step card vs CPU from the
               same parameters and batch with TF32 off (loss within 1e-4,
               gradient global norm within 1e-3) and, for flow and depth,
               TF32 on vs off (loss within 1e-2); 20 steps (finite losses,
               steps/s, peak GB); the flow trainer's checkpoint read back
               through the pipeline's `_load_raft_apply`; K1 in the flow
               trainer's validation (`[kernel-val]`, 32x40 grid, batch 4:
               4-byte copies, as level widths 10 and 5 are not multiples of
               4) held against the plain lookup; train_cli --synthetic3d.
  9. sweep   — a multi-sequence evaluation sweep as a user runs it: renders
               hb_01_dyn (held-out family B, scripts/make_heldout_set.py's
               recipe) and seq_01_dyn (family A), 48 frames at 1024x436 each
               with .cam poses and dynamic masks; runs `run.main(["--root_dir",
               ...])` in-process on the card (each net built and each
               checkpoint parsed once, 192 K1 launches per sequence, model bins
               and >= 3 finite converted poses each; stage times, the loaders'
               seconds per sequence and ATE against the renderer printed);
               `eval.sintel` on it (errors_ate.txt equals evaluate_sequence on
               the same files) and `trajectory_label_metrics` of each labeled
               track set; `sfm.visualize` on each model (PLY vertices = points
               + 5 x cameras, the HTML's positions are the model's xyz);
               `write_overlay_video` on hb_01_dyn (48 PNGs, a GIF, an AVI read
               back as 48 frames); one 8-pair flow block under
               `utils.profiling.trace`, whose Chrome trace must name K1.
The last two lines are the card's `name, power.limit` and
{"ok": true, "device": {...}}; the line before them lists the kernels (the
`*_net` keys are the `[kernel-net]` numbers, the `*_half` keys those of
`[kernel-half]` and the half-scale flow stage's launches, the `*_val` keys
those of `[kernel-val]`, `launches_train` the flow trainer's,
`launches_sweep` the sweep's and `launches_mesh` the flow apply's on
[mesh]'s logical mesh, over all its shards; K2's `launches` is [slice]'s
run_pipeline's).
"""
from __future__ import annotations

import argparse
import base64
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
SFM_DUMP_TRACKS = 30_000       # the labeled-track subset of the incremental card-vs-CPU
                               # check and the JAX compare (--dump)
SWEEP_SEQS = ("hb_01_dyn", "seq_01_dyn")    # [sweep], in the --root_dir run's (sorted) order
HELDOUT_SEED = 11              # scripts/make_heldout_set.py's default --seed


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


def save_tracks_compressed(src: Path, dst: Path) -> None:
    """A tracks.npz rewritten compressed for a dump (TrackArrays.load reads
    both): a 30,000-track subset shrinks from 14.4 MB to ~2 MB, which keeps
    a --dump with the [sweep] subsets under 64 MiB."""
    z = np.load(src)
    np.savez_compressed(dst, **{k: z[k] for k in z.files})


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


# K2's work per eligible slot, counted from csrc/track_lm.cu (+ - * / sqrt,
# a fused multiply-add as two; clamps and floors not counted): the three
# anchor samples and the damping gate (75), one model evaluation (83: the
# flow sample with its Jacobian, residuals, cost, g and J^T J), and per LM
# step a 4x4 Cholesky solve with the step and the damping (70) and an
# evaluation.
TRACK_LM_FLOPS = (75, 83, 70)


def track_lm_bound(H: int, W: int, C: int, eligible: int, num_iters: int) -> tuple:
    """(bytes, FLOPs) one K2 launch must move and compute: the four maps
    read once (eligible heads every ~2 px touch all of them), survive and
    start_time of every slot, the three positions of each eligible slot read
    and two written."""
    nbytes = H * W * (3 * 8 + 4) + C * (1 + 4) + eligible * (3 * 8 + 2 * 8)
    a, e, step = TRACK_LM_FLOPS
    return nbytes, eligible * (a + e + num_iters * (step + e))


def phase_track_lm(dev, C=131_072, H=436, W=1024, f=5, num_iters=12):
    """K2 vs the plain refinement step (`tracks/optimize.py` track_lm_plain)
    on one frame state at the main path's shapes: smooth random flows, 90%
    of the slots eligible, heads over the whole image."""
    import torch
    import torch.nn.functional as F

    from particlesfm_tpu_torch.tracks import optimize as lm

    g = torch.Generator(device=dev).manual_seed(0)

    def smooth(amp):
        coarse = amp * torch.randn(1, 2, H // 32 + 2, W // 32 + 2, generator=g, device=dev)
        fl = F.interpolate(coarse, size=(H, W), mode="bicubic", align_corners=True)[0]
        return (fl.permute(1, 2, 0) + 0.3 * torch.randn(H, W, 2, generator=g, device=dev)
                ).contiguous()

    maps = (smooth(4), smooth(4), smooth(8),
            (torch.rand(H, W, generator=g, device=dev) < 0.1).float())
    size = torch.tensor([W - 1.0, H - 1.0], device=dev)
    prev1 = size * torch.rand(C, 2, generator=g, device=dev)
    prev2 = prev1 + torch.randn(C, 2, generator=g, device=dev)
    new_pos = prev1 + torch.randn(C, 2, generator=g, device=dev)
    survive = torch.rand(C, generator=g, device=dev) < 0.9
    start_time = torch.zeros(C, dtype=torch.int32, device=dev)
    eligible = int(survive.sum())

    out = []
    for fn in (lm.track_lm_cuda, lm.track_lm_plain):
        p1, p2 = prev1.clone(), new_pos.clone()
        fn(*maps, prev2, p1, p2, survive, start_time, f, 20.0, num_iters, True)
        out.append(torch.cat([p1, p2], -1))
    gap = (out[0] - out[1]).view(C, 2, 2).norm(dim=-1).amax(-1)[survive]
    bad = int((gap > 1e-4).sum())
    exact = float((out[0] == out[1])[survive].all(-1).float().mean())
    if bad > 1e-4 * eligible:
        fail(f"track_lm: {bad} of {eligible} eligible slots differ by more than 1e-4 px")

    def timed(fn):
        p1, p2 = prev1.clone(), new_pos.clone()
        return time_ms(lambda: fn(*maps, prev2, p1, p2, survive, start_time, f, 20.0,
                                  num_iters, True))

    ms = timed(lm.track_lm_cuda)
    host = []
    p1, p2 = prev1.clone(), new_pos.clone()
    for _ in range(5):             # host time of one call, median of 5 x 20 calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            lm.track_lm_cuda(*maps, prev2, p1, p2, survive, start_time, f, 20.0, num_iters,
                             True)
        host.append((time.perf_counter() - t0) / 20 * 1e3)
    torch.cuda.synchronize()
    plain_ms = timed(lm.track_lm_plain)
    nbytes, flops = track_lm_bound(H, W, C, eligible, num_iters)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOPS * 1e3
    res = dict(ms=ms, host_ms=float(np.median(host)), plain_ms=plain_ms,
               bound_ms=max(bound_bytes_ms, bound_ops_ms),
               bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
               bytes=nbytes, flops=flops, max_gap_px=float(gap.max()), slots_over_1e4=bad,
               bit_equal=exact)
    log(f"[track_lm] C={C} {W}x{H} iters={num_iters} patch: {eligible} eligible, {bad} "
        f"moved > 1e-4 px from plain (largest {res['max_gap_px']:.3e} px, bit-equal "
        f"{100 * exact:.4f}%); K2 {ms:.4f} ms (host {res['host_ms']:.4f} ms/call), plain "
        f"{plain_ms:.4f} ms; bound {res['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB -> "
        f"{bound_bytes_ms:.4f} ms, {flops / 1e9:.3f} GFLOP -> {bound_ops_ms:.4f} ms; "
        f"{res['bound_by']}) -> {100 * res['bound_ms'] / ms:.1f}% of bound")
    return res


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
    miss = info["focal"] / gt_focal - 1
    log(f"[selfcal] focal {info['focal']:.2f} px (renderer {gt_focal:.2f} px, "
        f"{100 * miss:+.2f}%), confidence {info['confidence']:.3f}, dip "
        f"{info['dip']:.4f}, num_pairs {info['num_pairs']}, interior "
        f"{info['interior']}")
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
    (`_build_depth_apply`: blocks of 4 frames, float16 rounding) on the card
    against the CPU on the first block of 4 full frames: normalized depth
    before the rounding within 1e-3, and the card's rounded output against
    the run's own depth of those frames; Pearson correlation with GT."""
    import torch

    from particlesfm_tpu_torch.io.images import load_image_stack
    from particlesfm_tpu_torch.models import depth as depth_mod
    from particlesfm_tpu_torch.pipeline import run as R
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
    # normalized depth before the float16 rounding, and build the applies
    # afresh, outside the pipeline's apply cache (neither the run's cached
    # apply nor these wrapped ones may serve another run)
    orig, raw, rounded = depth_mod.normalize_depth, [], []     # card, CPU
    ckpt = cfg.depth.checkpoint or R.DEFAULT_DEPTH_CKPT
    try:
        for d in (dev, torch.device("cpu")):
            kept = []
            depth_mod.normalize_depth = lambda x, kept=kept: kept.append(orig(x)) or kept[-1]
            rounded.append(R._build_depth_apply(ckpt, cfg.depth.base, d)(stack.to(d)).cpu())
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
    fwd = next(m for m in msgs if m.startswith("[motionseg]") and "chunks of" in m)
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

    def __init__(self, targets=None, keep_all=()):
        from particlesfm_tpu_torch.pipeline import stages
        from particlesfm_tpu_torch.sfm import mapper

        if targets is None:
            targets = [(mapper, self.TIMED),
                       (stages, ("write_models", "write_converted_outputs"))]
        self.first, self.last, self.secs, self.count, self._orig = {}, {}, {}, {}, []
        self.calls = {name: [] for name in keep_all}     # every call of these
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
            if name in self.calls:
                self.calls[name].append((a, kw, out))
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
    torch.profiler (the same registered frames, poses within 1e-6). A seeded
    subset of SFM_DUMP_TRACKS labeled tracks is saved with selfcal.json for
    the incremental mapper's card-vs-CPU run in [modes]; with `dump` the
    stage also runs on it, and it is saved beside the dump: the full set
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
    rows = np.sort(np.random.default_rng(0).choice(lab.num_tracks, SFM_DUMP_TRACKS,
                                                   replace=False))
    sub = TrackArrays(xy=lab.xy[rows], mask=lab.mask[rows], labels=lab.labels[rows])
    sub_dir = WORK / "sfm_subset"
    sub_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(out_dir / "selfcal.json", sub_dir / "selfcal.json")
    sub.save(sub_dir / "tracks.npz")
    if dump:
        r = stages.sfm_stage(sub, H, W, sub_dir, cfg, dev, names, log=lambda *a: None)
        log(f"[sfm] --dump: {SFM_DUMP_TRACKS} of {lab.num_tracks} labeled tracks (seed 0): "
            f"{r.num_registered}/{T} registered on the card")
        out.update(sfm_sub_registered=r.registered, sfm_sub_qvec=r.qvec, sfm_sub_tvec=r.tvec,
                   sfm_sub_params=r.params)
    return out


def phase_slice(dev, frames: int, dump: bool = False):
    import torch

    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.tracks import optimize as lm

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
        lm.reset_launches()
        t0 = time.perf_counter()
        R.run_pipeline(img_dir, out_dir, cfg, log=msgs.append, device=dev)
        wall = time.perf_counter() - t0
        launches, vec_launches, lm_launches = cl.launches, cl.vec_launches, lm.launches
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
    if lm_launches != frames - 2:
        fail(f"slice: K2 launched {lm_launches} times, expected one a flow from the second "
             f"({frames - 2})")
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
    timings = (out_dir / "timings.txt").read_text().strip().splitlines()
    stage_s = {ln.split()[0]: float(ln.split()[1].rstrip("s")) for ln in timings[1:]}
    for stage in ("frame_upload", "flow", "trajectories", "depth", "motion_seg", "sfm"):
        if stage not in stage_s:
            fail(f"slice: no '{stage}' stage in timings.txt")
    log(f"[slice] run_pipeline {wall:.2f}s: stages {json.dumps(stage_s)}; "
        f"{n_pairs} pairs in {blocks} blocks; K1 launches {launches} ({vec_launches} with "
        f"16-byte copies); K2 launches {lm_launches}; "
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
    return dict(launches=launches, lm_launches=lm_launches, img_dir=img_dir, dump=dump,
                gt=gt, out_dir=out_dir, last_ba=solvers.last["bundle_adjust"], cfg=cfg,
                flows=flows, tracks=tracks, depths=kept["depth_stage"])


MESH_SHARDS = 4               # [mesh]'s logical mesh on one card: [cuda:0] * 4
MESH_PAIRS = 32               # flow_f's first pairs: one block of 8 pairs per shard


def _synced(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ba_gaps(got, ref) -> dict:
    """Cost (relative), q, t and X (max abs) of a BA result against another."""
    cost, cost_ref = float(got.cost), float(ref.cost)
    return dict(cost=abs(cost - cost_ref) / max(abs(cost_ref), 1e-30),
                q=float((got.q - ref.q).abs().max()), t=float((got.t - ref.t).abs().max()),
                X=float((got.X - ref.X).abs().max()))


def _gaps_text(g: dict) -> str:
    return (f"cost {g['cost']:.3e} relative, q {g['q']:.3e}, t {g['t']:.3e}, "
            f"X {g['X']:.3e}")


BA_TOL = dict(cost=1e-3, q=1e-4, t=1e-3, X=1e-3)    # tests/test_parallel.py:135-140


def mesh_checks(dev, tag: str, mesh, s: dict):
    """[mesh]'s checks of the data-parallel paths on `mesh`, each against the
    one-device path on the same inputs from [slice]'s run: returns the
    sharded BA result and K1's launches in the mesh's flow apply."""
    import torch

    from particlesfm_tpu_torch.globalsfm.ba import bundle_adjust
    from particlesfm_tpu_torch.io.images import load_image_stack
    from particlesfm_tpu_torch.motionseg import segment_tracks
    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.ops.flow_ops import occlusion_mask
    from particlesfm_tpu_torch.parallel import sharded_bundle_adjust, sharded_map_frames
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline.stages import upload_frame_stack
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    cfg, flows, depths, nd = s["cfg"], s["flows"], s["depths"], mesh.size
    where = f"[mesh] {tag} ({nd} shards: {', '.join(mesh.key())})"

    # (a) occlusion checks over the run's forward/backward pairs
    thr = cfg.track.flow_check_thres
    ff, fb = flows["flow_f"], flows["flow_b"]
    (occ1, err1), t1 = _synced(lambda: occlusion_mask(ff, fb, thr))
    (occ, err), tm = _synced(lambda: sharded_map_frames(
        lambda f, b: occlusion_mask(f, b, thr), mesh, ff, fb))
    d_occ, d_err = float((occ - occ1).abs().max()), float((err - err1).abs().max())
    log(f"{where} sharded_map_frames(occlusion_mask) on the run's {ff.shape[0]} pairs: max "
        f"|diff| occ {d_occ:.3e} err {d_err:.3e}; {tm:.4f}s vs one device {t1:.4f}s")
    if d_occ or d_err:
        fail(f"mesh: {tag} sharded occlusion check differs from the unsharded one")

    # (b) the pipeline's flow apply on flow_f's first pairs
    images, _ = load_image_stack(s["img_dir"])
    stack = upload_frame_stack(images, dev)
    ia = np.arange(MESH_PAIRS)
    one, meshed = R._load_raft_apply(cfg, dev), R._load_raft_apply(cfg, mesh)
    cl.reset_launches()
    fl1, t1 = _synced(lambda: one(stack, ia, ia + 1))
    n1 = cl.launches
    cl.reset_launches()
    flm, tm = _synced(lambda: meshed(stack, ia, ia + 1))
    nm = cl.launches
    d_one = float((flm - fl1).abs().max())
    d_run = float((flm - flows["flow_f"][:MESH_PAIRS]).abs().max())
    log(f"{where} flow apply on the run's first {MESH_PAIRS} pairs: max |diff| vs one device "
        f"{d_one:.3e}, vs the run's flows {d_run:.3e}; K1 launches {nm} (one device {n1}); "
        f"{tm:.3f}s vs one device {t1:.3f}s")
    if d_one or d_run:
        fail(f"mesh: {tag} flows differ from the one-device flows ({d_one}, {d_run})")
    if nm != n1 or nm != MESH_PAIRS // cfg.flow.per_device * cfg.flow.iters:
        fail(f"mesh: {tag} K1 launched {nm} times, one device {n1}")

    # (c) the depth apply on 8 frames
    depth1, depthm = R._load_depth_apply(cfg, dev), R._load_depth_apply(cfg, mesh)
    d1, t1 = _synced(lambda: depth1(stack[:8]))
    dm, tm = _synced(lambda: depthm(stack[:8]))
    d_one, d_run = float((dm - d1).abs().max()), float((dm - depths[:8]).abs().max())
    log(f"{where} depth apply on 8 frames: max |diff| vs one device {d_one:.3e}, vs the "
        f"run's depth {d_run:.3e}; {tm:.3f}s vs one device {t1:.3f}s")
    if d_one or d_run:
        fail(f"mesh: {tag} depths differ from the one-device depths ({d_one}, {d_run})")

    # (d) the seg apply's window split, under segment_tracks on the run's tracks
    H, W = images.shape[1:3]
    seg1, segm = R._load_seg_apply(cfg, dev), R._load_seg_apply(cfg, mesh)
    thr = cfg.motionseg.threshold
    if seg1.threshold is not None and abs(thr - 0.5) < 1e-9:
        thr = float(seg1.threshold)         # as motionseg_stage decides it
    kw = dict(window_size=cfg.motionseg.window_size, traj_max_num=cfg.motionseg.traj_max_num,
              threshold=thr)
    logits = {"one": [], "mesh": []}

    def recording(apply, key):
        def rec(traj, depth, valid):
            out = apply(traj, depth, valid)
            logits[key].append(out)
            return out
        rec.accepts_u16 = apply.accepts_u16
        return rec

    lab1, t1 = _synced(lambda: segment_tracks(recording(seg1, "one"), s["tracks"], depths,
                                              (H, W), **kw).labels)
    labm, tm = _synced(lambda: segment_tracks(recording(segm, "mesh"), s["tracks"], depths,
                                              (H, W), **kw).labels)
    B = logits["one"][0].shape[0]
    lg1, lgm = torch.cat(logits["one"], 1), torch.cat(logits["mesh"], 1)
    run_labels = TrackArrays.load(s["out_dir"] / "trajectories_labeled" / "tracks.npz").labels
    d_lg = float((lgm - lg1).abs().max())
    n_run, n_one = int((labm != run_labels).sum()), int((labm != lab1).sum())
    log(f"{where} segment_tracks on the run's {s['tracks'].num_tracks} tracks, {B} windows "
        f"on {nd} shards: max |logit diff| vs one device {d_lg:.3e}; labels differing from the "
        f"run's {n_run}, from one device {n_one}; {tm:.3f}s vs one device {t1:.3f}s")
    if n_run or n_one:
        fail(f"mesh: {tag} labels differ from the run's ({n_run}) or one device's ({n_one})")

    # (e) sharded BA on [slice]'s last BA problem. The LM loop stops after two
    # accepted steps that improve the cost by < function_tolerance; the
    # shards' sums round differently from plain BA's, so that test may stop
    # the two a step apart, and the gate compares them at the same step count
    a, bkw, _ = s["last_ba"]
    plain, tp = _synced(lambda: bundle_adjust(*a, **bkw))
    sh, ts = _synced(lambda: sharded_bundle_adjust(mesh, *a, **bkw))
    ref, got = plain, sh
    if sh.iters != plain.iters:
        steps = dict(bkw, max_iterations=min(sh.iters, plain.iters))
        ref = plain if plain.iters < sh.iters else bundle_adjust(*a, **steps)
        got = sh if sh.iters < plain.iters else sharded_bundle_adjust(mesh, *a, **steps)
    gaps = _ba_gaps(got, ref)
    moved = (sh.X - plain.X).norm(dim=-1)
    log(f"{where} sharded_bundle_adjust on [slice]'s last BA problem ({a[0].shape[0]} views, "
        f"{a[3].shape[0]} tracks): LM iterations {sh.iters} / plain {plain.iters}, at the "
        f"mapper's stop rule vs plain {_gaps_text(_ba_gaps(sh, plain))} (points moved > 1e-3: "
        f"{int((moved > 1e-3).sum())}); at {got.iters} / {ref.iters} steps "
        f"{_gaps_text(gaps)} (tolerances {json.dumps(BA_TOL)}); {ts:.3f}s vs plain {tp:.3f}s")
    if got.iters != ref.iters or any(gaps[k] > BA_TOL[k] for k in BA_TOL):
        fail(f"mesh: {tag} sharded BA outside the tolerances of plain BA at "
             f"{got.iters} / {ref.iters} steps: {gaps}")
    return sh, nm


def phase_mesh(dev, s: dict, dump: bool) -> dict:
    """Phase [mesh]: the device mesh on [slice]'s own data. make_mesh()
    covers every visible card; on a logical mesh of MESH_SHARDS copies of
    the card (overhead and correctness, not scaling) and, with more than
    one card, on the real mesh: the sharded occlusion check, flow and depth
    applies equal the one-device ones bit for bit (the same K1 launch
    count), the seg apply's labels equal them, and sharded BA stays within the reference test's tolerances of
    plain BA; then the same sharded BA in a world-size-1 NCCL group, whose
    all-reduce must leave it bit-identical. Returns K1's launches in the
    logical mesh's flow apply and, with `dump`, the BA problem and the
    card's 4-shard result for the JAX compare."""
    import socket

    import torch
    import torch.distributed as dist

    from particlesfm_tpu_torch.parallel import (init_distributed, make_mesh,
                                                sharded_bundle_adjust)

    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    every = make_mesh()
    if every.key() != tuple(f"cuda:{i}" for i in range(n)):
        fail(f"mesh: make_mesh() covers {every.key()}, device_count() is {n}")
    log(f"[mesh] make_mesh() covers the {n} visible card(s): {', '.join(every.key())}")
    logical = make_mesh(devices=[dev] * MESH_SHARDS)
    sh, launches = mesh_checks(dev, f"logical mesh of {MESH_SHARDS} x {dev}", logical, s)

    a, bkw, _ = s["last_ba"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        shn, tn = _synced(lambda: sharded_bundle_adjust(logical, *a, **bkw))
        world = dist.get_world_size()
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(getattr(shn, k), getattr(sh, k)) for k in ("q", "t", "X", "cost"))
    log(f"[mesh] the same sharded BA in a world-size-{world} NCCL group (its sums all-reduced "
        f"on the card): bit-identical to the in-process result {same}; {tn:.3f}s")
    if not same or shn.iters != sh.iters:
        fail("mesh: sharded BA through the NCCL all-reduce differs from the in-process one")

    if n > 1:
        mesh_checks(dev, f"mesh of the {n} cards", every, s)
    else:
        log("[mesh] one card visible: the multi-card mesh was not run (absent hardware)")
    log(f"[mesh] {time.perf_counter() - t0:.1f}s")
    if not dump:
        return dict(launches=launches, dump={})
    q, t, params, X, obs, free, pm = a
    return dict(launches=launches, dump=dict(mesh_ba_q=q.cpu().numpy(), mesh_ba_t=t.cpu().numpy(),
                mesh_ba_params=params.cpu().numpy(), mesh_ba_X=X.cpu().numpy(),
                mesh_ba_fidx=obs.frame_idx.cpu().numpy().astype(np.int32), mesh_ba_uv=obs.uv.cpu().numpy(),
                mesh_ba_mask=obs.mask.cpu().numpy(), mesh_ba_free=free.cpu().numpy(),
                mesh_ba_pm=pm.cpu().numpy(),
                mesh_ba_kw=json.dumps({k: v for k, v in bkw.items() if k != "focal_bounds"}),
                mesh_ba_focal_bounds=(np.full(2, np.nan, np.float32)
                                      if bkw.get("focal_bounds") is None
                                      else bkw["focal_bounds"].cpu().numpy()),
                mesh_ba_out_q=sh.q.cpu().numpy(), mesh_ba_out_t=sh.t.cpu().numpy(),
                mesh_ba_out_X=sh.X.cpu().numpy(), mesh_ba_out_cost=sh.cost.cpu().numpy(),
                mesh_ba_out_iters=np.int64(sh.iters), mesh_shards=np.int64(MESH_SHARDS)))


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
                         (stages, ("write_colmap_model", "write_converted_outputs"))],
                        keep_all=("estimate_pose_pnp",))
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
    check_every_pnp("(a)", solvers.calls["estimate_pose_pnp"])
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


def check_every_pnp(tag: str, calls) -> None:
    """Every PnP call of a run, card against CPU on the card's inputs: equal
    inlier counts (the run's own count against the CPU's)."""
    from particlesfm_tpu_torch.sfm import incremental

    t0 = time.perf_counter()
    diff, counts = [], []
    for i, (a, kw, out) in enumerate(calls):
        n_card = int(out.num_inliers)
        n_cpu = int(incremental.estimate_pose_pnp(*_to_cpu(a), **_to_cpu(kw)).num_inliers)
        counts.append(n_card)
        if n_card != n_cpu:
            diff.append((i, n_card, n_cpu))
    n_fail = sum(c < 15 for c in counts)
    log(f"[modes] {tag} card vs CPU, every PnP call of the run on the card's inputs: "
        f"{len(calls)} calls ({n_fail} with < 15 inliers), {len(diff)} inlier counts "
        f"differ {diff[:5]}; CPU {time.perf_counter() - t0:.2f}s")
    if not calls or diff:
        fail(f"modes: {tag} {len(diff)} of {len(calls)} PnP calls card vs CPU differ: {diff[:5]}")


def _cpu_incremental(sub_dir: str, H: int, W: int, T: int, out_npz: str) -> None:
    """Worker process: the incremental SfM stage on the CPU on the track
    subset (4 torch threads), its registered frames and order to out_npz."""
    import torch

    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    torch.set_num_threads(4)
    cfg = R.config_from_args(R.build_arg_parser().parse_args(
        ["--image_dir", "-", "--output_dir", "-", "--sfm_type", "incremental"]))
    d = Path(sub_dir).parent / "sub_incremental_cpu"
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(Path(sub_dir) / "selfcal.json", d / "selfcal.json")
    msgs = []
    t0 = time.perf_counter()
    r = stages.sfm_stage(TrackArrays.load(Path(sub_dir) / "tracks.npz"), H, W, d, cfg, "cpu",
                         [f"{i:06d}.ppm" for i in range(T)], log=msgs.append)
    np.savez(out_npz, registered=r.registered, order=np.array(_registration_order(msgs)),
             secs=time.perf_counter() - t0)


def start_cpu_incremental(gt):
    """Start the CPU run of the incremental stage on the subset in a worker
    process (it overlaps the card phases); `modes_subset` joins it."""
    H, W = gt["dynamic"].shape[1:]
    out = WORK / "sub_incremental_cpu.npz"
    proc = mp.get_context("spawn").Process(
        target=_cpu_incremental,
        args=(str(WORK / "sfm_subset"), H, W, len(gt["w2c"]), str(out)))
    proc.start()
    return proc, out


def modes_subset(dev, gt, cpu_run) -> dict:
    """The incremental SfM stage on the SFM_DUMP_TRACKS-track subset on the
    card, every PnP call of it card vs CPU, and the same stage on the CPU
    (the worker of `start_cpu_incremental`): the same registered frames."""
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.sfm import incremental
    from particlesfm_tpu_torch.tracks.store import TrackArrays

    sub = TrackArrays.load(WORK / "sfm_subset" / "tracks.npz")
    T = len(gt["w2c"])
    H, W = gt["dynamic"].shape[1:]
    cfg = R.config_from_args(R.build_arg_parser().parse_args(
        ["--image_dir", "-", "--output_dir", "-", "--sfm_type", "incremental"]))
    solvers = SolverLog([(incremental, ("estimate_pose_pnp",))], keep_all=("estimate_pose_pnp",))
    msgs = []
    try:
        t0 = time.perf_counter()
        r = stages.sfm_stage(sub, H, W, _stage_dir("sub_incremental", WORK / "sfm_subset"),
                             cfg, dev, [f"{i:06d}.ppm" for i in range(T)], log=msgs.append)
        secs = time.perf_counter() - t0
    finally:
        solvers.restore()
    check_every_pnp("subset", solvers.calls["estimate_pose_pnp"])
    proc, out = cpu_run
    proc.join()
    if proc.exitcode != 0:
        fail(f"modes: the CPU incremental run on the subset exited {proc.exitcode}")
    z = np.load(out)
    order = _registration_order(msgs)
    same_set = bool((z["registered"] == r.registered).all())
    log(f"[modes] (a) the incremental stage on the {SFM_DUMP_TRACKS}-track subset: card "
        f"{r.num_registered}/{T} registered in {secs:.2f}s, CPU {int(z['registered'].sum())}/{T} "
        f"in {float(z['secs']):.2f}s; same registered frames {same_set}, same order "
        f"{order == z['order'].tolist()}; card only "
        f"{np.nonzero(r.registered & ~z['registered'])[0].tolist()}, CPU only "
        f"{np.nonzero(z['registered'] & ~r.registered)[0].tolist()}")
    if not same_set:
        fail("modes: the card and the CPU register other frames on the track subset")
    return {"sfm_sub_incremental_registered": r.registered, "sfm_sub_incremental_qvec": r.qvec,
            "sfm_sub_incremental_tvec": r.tvec, "sfm_sub_incremental_params": r.params}


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
    """Phase 5: the other run_pipeline options on the slice's frames, and the
    incremental stage on the track subset card vs CPU. With `dump`, the
    linear and nonlinear stages also run on the subset; its poses go into
    the dump."""
    cpu_run = start_cpu_incremental(s["gt"])
    try:
        res = modes_incremental(dev, s["img_dir"], s["gt"])
        modes_positions(dev, s["out_dir"], s["gt"])
        modes_pcg(s["last_ba"])
        res.update(modes_half_flow(dev, s["img_dir"], s["gt"]))
        sub = modes_subset(dev, s["gt"], cpu_run)
    finally:
        if cpu_run[0].is_alive():
            cpu_run[0].terminate()
        cpu_run[0].join()
    if dump:
        s["dump"].update(sub)
        from particlesfm_tpu_torch.pipeline import run as R
        from particlesfm_tpu_torch.pipeline import stages
        from particlesfm_tpu_torch.tracks.store import TrackArrays

        sub = TrackArrays.load(WORK / "sfm_subset" / "tracks.npz")
        T = len(s["gt"]["w2c"])
        H, W = s["gt"]["dynamic"].shape[1:]
        names = [f"{i:06d}.ppm" for i in range(T)]
        for mode, extra in (("linear", ["--set", "sfm.position.method=linear"]),
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


def _train_compare(tag: str, step_fn, use_tf32: bool = True) -> dict:
    """One training step from the same parameters and batch on the card and
    on the CPU with TF32 off (`step_fn(device, use_tf32) -> (loss, grad
    norm)`): loss within 1e-4 relative, the gradients' global norm within
    1e-3; with `use_tf32`, the card's step with TF32 on against off: loss
    within 1e-2."""
    t0 = time.perf_counter()
    lc, gc = step_fn("cuda", False)
    lp, gp = step_fn("cpu", False)
    res = dict(loss_rel=abs(lc - lp) / abs(lp), grad_rel=abs(gc - gp) / gp,
               cpu_s=time.perf_counter() - t0)
    msg = (f"[train] {tag}: card vs CPU, one step from the same parameters and batch, TF32 "
           f"off: loss {lc:.6f} / {lp:.6f} ({res['loss_rel']:.2e} relative), gradient global "
           f"norm {gc:.6f} / {gp:.6f} ({res['grad_rel']:.2e})")
    if use_tf32:
        lt, gt = step_fn("cuda", True)
        res["tf32_rel"] = abs(lt - lc) / abs(lc)
        msg += (f"; TF32 on vs off on the card: loss {lt:.6f} ({res['tf32_rel']:.2e} "
                f"relative), gradient norm {gt:.6f}")
    else:
        msg += "; TF32 not used (the reference trains it at full float32 precision)"
    log(msg)
    if not (res["loss_rel"] <= 1e-4 and res["grad_rel"] <= 1e-3):
        fail(f"train: {tag} card vs CPU step differs: {res}")
    if use_tf32 and not res["tf32_rel"] <= 1e-2:
        fail(f"train: {tag} TF32 moves the loss by {res['tf32_rel']:.2e} > 1e-2")
    return res


def _timed_run(fn):
    """fn() with the card's peak allocation reset first: (result, seconds,
    peak GB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def train_flow(dev) -> dict:
    """The flow trainer at its defaults (batch 4, crop 192x256, 12
    iterations) warm-started from checkpoints/raft_synth.msgpack on 4
    rendered scenes (48 pairs, 8 held out): 20 steps through `train`, whose
    validation runs the inference model with K1 (2 batches of 4 pairs at a
    32x40 grid, 12 iterations); card vs CPU and TF32 checks on one step; the
    best checkpoint read back through the pipeline's `_load_raft_apply`."""
    import copy

    import torch

    from particlesfm_tpu_torch.flow import data as fdata
    from particlesfm_tpu_torch.flow import train as ft
    from particlesfm_tpu_torch.flow.infer import load_model
    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.ops.corr_lookup import lookup_corr, lookup_corr_plain
    from particlesfm_tpu_torch.pipeline import run as R

    d = WORK / "train_flow"
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    i1, i2, fl = fdata.generate_dataset(4, fdata.FlowPairSpec(), seed=0,
                                        workers=min(8, os.cpu_count() or 1), log=lambda *a: None)
    fdata.save_dataset(d / "pairs.npz", i1, i2, fl)
    render_s = time.perf_counter() - t0
    init = ROOT / "checkpoints" / "raft_synth.msgpack"
    steps, batch, iters, crop = 20, 4, 12, (192, 256)

    crop = tuple(min(c, n) for c, n in zip(crop, i1.shape[1:3]))    # as `train` clamps it
    base = ft.build_model(0, init, "cpu", log=lambda *a: None)
    n_val = min(max(8, len(i1) // 20), len(i1) // 2)
    idx, offs = ft.step_draws(0, 0, len(i1) - n_val, batch, *i1.shape[1:3], *crop)
    tr = [torch.from_numpy(a[n_val:]) for a in (i1, i2, fl)]

    def one_step(device, use_tf32):
        model = copy.deepcopy(base).to(device)
        b = ft.gather_batch(*(t.to(device) for t in tr), torch.from_numpy(idx).to(device),
                            torch.from_numpy(offs).to(device), crop)
        loss = ft.loss_and_grads(model, *b, iters, use_tf32)
        gn = optim_norm([p.grad for p in model.parameters()])
        return float(loss), gn

    cmp = _train_compare("flow", one_step)
    stats = {}
    out = d / "raft_train.msgpack"
    cl.reset_launches()
    best, secs, peak = _timed_run(lambda: ft.train(
        out, steps=steps, batch=batch, iters=iters, dataset_cache=str(d / "pairs.npz"),
        eval_every=steps, crop_hw=crop, init_ckpt=str(init), log=lambda *a: None, device=dev,
        stats=stats))
    launches, vec_launches = cl.launches, cl.vec_launches
    losses = stats["losses"]
    n_val_batches = math.ceil(n_val / batch)
    if launches != n_val_batches * iters or vec_launches != 0:
        fail(f"train: flow validation launched K1 {launches} times ({vec_launches} 16-byte), "
             f"expected {n_val_batches * iters} with 4-byte copies (level widths 40/20/10/5)")
    if not (np.isfinite(losses).all() and len(losses) == steps and np.isfinite(best)):
        fail(f"train: flow losses {losses} / best EPE {best}")
    cfg = R.config_from_args(R.build_arg_parser().parse_args(
        ["--image_dir", "-", "--output_dir", "-", "--set", f"flow.checkpoint={out}"]))
    apply = R._load_raft_apply(cfg, dev)
    stack = torch.from_numpy(np.stack([i1[0], i2[0]]))
    flow = apply(stack, [0], [1])
    if tuple(flow.shape) != (1, *i1.shape[1:3], 2) or not bool(torch.isfinite(flow).all()):
        fail("train: the trained flow checkpoint gave no finite flow through _load_raft_apply")

    # K1 at the validation shape: the checkpoint's net on the first held-out
    # batch with K1 and with the plain lookup; K1 measured on the last GRU
    # iteration's pyramid and coordinates
    model, _ = load_model(out, dev)
    a = torch.from_numpy(i1[:batch]).to(dev, torch.float32)
    b = torch.from_numpy(i2[:batch]).to(dev, torch.float32)
    last = {}

    def keep_last(pyramid, pts, radius):
        last.update(pyramid=pyramid, coords=pts, radius=radius)
        return lookup_corr(pyramid, pts, radius)

    with torch.inference_mode():
        model.lookup = keep_last
        fk = model(a, b, iters=iters)
        model.lookup = lookup_corr_plain
        fp = model(a, b, iters=iters)
        dd = (fk - fp).abs()
        mean_d, max_d = float(dd.mean()), float(dd.max())
        if not mean_d <= 1e-3:
            fail(f"train: K1 vs plain flows at the validation shape differ by {mean_d} px")
        H8, W8 = last["pyramid"][0].shape[-2:]
        log(f"[train] flow: rendered {len(i1)} pairs in {render_s:.1f}s; 20 steps "
            f"{secs:.2f}s = {steps / stats['seconds']:.2f} steps/s (loop), peak {peak:.2f} GB; "
            f"losses {np.round(losses.astype(float), 4).tolist()}; val EPE {best:.4f} px; K1 {launches} "
            f"launches in validation ({vec_launches} 16-byte); the checkpoint through "
            f"_load_raft_apply: flow {tuple(flow.shape)} finite; K1 vs plain at the "
            f"validation shape ({batch} pairs, grid {H8}x{W8}): flow |diff| mean "
            f"{mean_d:.3e} px, max {max_d:.3e} px")
        k = measure_lookup("kernel-val", last["pyramid"], last["coords"], last["radius"],
                           vec=False)
    return dict(cmp, losses=losses, steps_per_s=steps / stats["seconds"], peak_gb=peak,
                launches=launches, kernel=k)


def optim_norm(grads) -> float:
    from particlesfm_tpu_torch.utils.optim import global_norm

    return float(global_norm([g.float().cpu() for g in grads]))


def train_depth(dev) -> dict:
    """The depth trainer at its defaults (batch 8, 256x320) on 6 rendered
    scenes (18 frames, 8 held out): 20 steps through `train`; card vs CPU and
    TF32 checks on one step."""
    import copy

    import torch

    from particlesfm_tpu_torch.depth import train as dt

    d = WORK / "train_depth"
    d.mkdir(parents=True)
    imgs, deps = dt.generate_depth_dataset(6, seed=0, workers=min(8, os.cpu_count() or 1),
                                           log=lambda *a: None)
    np.savez(d / "frames.npz", images=imgs, depths=deps)
    base = dt.build_model(0, "cpu")
    n_val = min(max(8, len(imgs) // 20), len(imgs) // 2)
    idx = np.random.default_rng(0).integers(0, len(imgs) - n_val, 8)
    bi = torch.from_numpy(imgs[n_val:][idx]).float()
    bd = torch.from_numpy(deps[n_val:][idx]).float()

    def one_step(device, use_tf32):
        model = copy.deepcopy(base).to(device)
        loss = dt.loss_and_grads(model, bi.to(device), bd.to(device), use_tf32)
        return float(loss), optim_norm([p.grad for p in model.parameters()])

    cmp = _train_compare("depth", one_step)
    stats = {}
    best, secs, peak = _timed_run(lambda: dt.train(
        d / "depth_train.msgpack", steps=20, batch=8, dataset_cache=str(d / "frames.npz"),
        eval_every=20, log=lambda *a: None, device=dev, stats=stats))
    losses = stats["losses"]
    if not (np.isfinite(losses).all() and len(losses) == 20 and np.isfinite(best)):
        fail(f"train: depth losses {losses} / best SSI {best}")
    log(f"[train] depth: {len(imgs)} frames at {imgs.shape[2]}x{imgs.shape[1]}; 20 steps "
        f"{secs:.2f}s = {20 / stats['seconds']:.2f} steps/s (loop), peak {peak:.2f} GB; losses "
        f"{np.round(losses.astype(float), 5).tolist()}; val SSI-MSE {best:.5f}")
    return dict(cmp, losses=losses, steps_per_s=20 / stats["seconds"], peak_gb=peak)


def train_motionseg(dev) -> dict:
    """The motion-seg trainer at its --synthetic3d defaults (batch 4, depth
    34x60, 1088 track slots of 10 frames): card vs CPU on one step; 20 steps
    of train_step timed on pre-made batches; then train_cli itself for one
    epoch of 2 steps, whose checkpoint loads back strictly."""
    import copy

    import torch

    from particlesfm_tpu_torch.io.checkpoint import load_msgpack, motionseg_state_dict_from_jax
    from particlesfm_tpu_torch.models.motionseg import TrajOADepth
    from particlesfm_tpu_torch.motionseg import train as mt
    from particlesfm_tpu_torch.motionseg import train_cli
    from particlesfm_tpu_torch.motionseg.synth3d import synth3d_batch

    rng = np.random.default_rng(0)
    batches = [synth3d_batch(rng, B=4, depth_hw=(34, 60)) for _ in range(21)]
    base = TrajOADepth(input_hw=(34, 60))
    mt.create_train_state(base, 0)

    def one_step(device, use_tf32):
        model = copy.deepcopy(base).to(device).train()
        loss, _, _ = mt.loss_and_grads(model, batches[0])
        return float(loss), optim_norm([p.grad for p in model.parameters()])

    cmp = _train_compare("motionseg", one_step, use_tf32=False)
    model = copy.deepcopy(base).to(dev)
    state, opt = mt.create_train_state(model, 0)
    dev_batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()} for b in batches[1:]]

    def run():
        nonlocal state
        out = []
        for b in dev_batches:
            state, m = mt.train_step(model, opt, state, b)
            out.append(m["loss"])
        return torch.stack(out).cpu().numpy()

    losses, secs, peak = _timed_run(run)
    if not (np.isfinite(losses).all() and len(losses) == 20):
        fail(f"train: motionseg losses {losses}")
    d = WORK / "train_seg"
    rc = train_cli.main(["--synthetic3d", "--out_dir", str(d), "--epochs", "1",
                         "--steps_per_epoch", "2", "--device", str(dev)])
    blob = load_msgpack(d / "checkpoint_best.msgpack")
    TrajOADepth(input_hw=(34, 60)).load_state_dict(
        motionseg_state_dict_from_jax(blob["params"], blob["batch_stats"]), strict=True)
    if rc != 0 or int(blob["step"]) != 2:
        fail(f"train: train_cli --synthetic3d returned {rc}, step {blob.get('step')}")
    log(f"[train] motionseg: 20 steps {secs:.2f}s = {20 / secs:.2f} steps/s, peak {peak:.2f} GB; "
        f"losses {np.round(losses.astype(float), 4).tolist()}; train_cli --synthetic3d (1 epoch x 2 steps): "
        f"{(d / 'test_metrics.txt').read_text().strip()}")
    return dict(cmp, losses=losses, steps_per_s=20 / secs, peak_gb=peak)


def phase_train(dev) -> dict:
    """Phase [train]: the flow, depth and motion-seg trainers on the card."""
    res = {"flow": train_flow(dev), "depth": train_depth(dev),
           "motionseg": train_motionseg(dev)}
    log("[train] summary " + json.dumps({k: {"steps_per_s": round(v["steps_per_s"], 3),
                                             "peak_gb": round(v["peak_gb"], 3)}
                                         for k, v in res.items()}))
    return res



# ------------------------------------------------------------------- sweep --

def _sweep_scene(name: str, frames: int, h: int, w: int):
    """seq_01_dyn: family A, sequence 1 of scripts/make_acceptance_set.py
    (seed 0). hb_01_dyn: family B, sequence 1 of scripts/make_heldout_set.py
    (its default seed 11; odd sequences are dynamic), the same draws."""
    if name == "seq_01_dyn":
        return _scene(frames, seed=0, idx=1, h=h, w=w)
    from particlesfm_tpu_torch.synth.family_b import random_box_scene

    rng = np.random.default_rng(2000003 * HELDOUT_SEED + 1)
    focal = 1.2 * w * rng.uniform(0.85, 1.15)
    return random_box_scene(
        rng, num_views=frames, height=h, width=w, focal=focal,
        num_dynamic=int(rng.integers(1, 3)),
        motion_scale=float(rng.uniform(0.5, 1.1)),
        yaw_scale=float(rng.uniform(0.5, 1.5)),
        num_boxes=int(rng.integers(8, 15)),
    )


def _render_sweep_frame(job):
    """Worker: frame i of sweep sequence `name` as PPM, its .cam (K and
    world-to-camera) and its dynamic mask as PNG; returns the mask."""
    from PIL import Image

    from particlesfm_tpu_torch.eval.pose_eval import write_sintel_cam

    name, i, frames, h, w, root = job
    sc = _sweep_scene(name, frames, h, w)
    root = Path(root)
    Image.fromarray(sc.render(i)).save(root / "seqs" / name / "images" / f"{i:06d}.ppm")
    write_sintel_cam(root / "gt" / name / f"{i:06d}.cam", sc.intrinsics_matrix(),
                     sc.world_to_cam(i))
    dyn = sc.gt_dynamic(i)
    Image.fromarray((dyn * 255).astype(np.uint8)).save(root / "gt" / name / "dyn" / f"{i:06d}.png")
    return name, i, dyn


def render_sweep(root: Path, frames: int, h: int, w: int) -> dict:
    """Both sweep sequences on one host pool: name -> dynamic masks [T, H, W]."""
    for name in SWEEP_SEQS:
        (root / "seqs" / name / "images").mkdir(parents=True, exist_ok=True)
        (root / "gt" / name / "dyn").mkdir(parents=True, exist_ok=True)
    jobs = [(name, i, frames, h, w, str(root)) for name in SWEEP_SEQS for i in range(frames)]
    dyn = {name: [None] * frames for name in SWEEP_SEQS}
    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        for name, i, d in pool.imap_unordered(_render_sweep_frame, jobs):
            dyn[name][i] = d
    return {name: np.stack(v) for name, v in dyn.items()}


class _SweepProbe:
    """Instruments a `--root_dir` run in-process: per sequence the K1
    launches, the loaders' seconds (device-synchronized), the run's messages
    and result; over the run, how often each net is constructed and each
    checkpoint parsed. `restore()` undoes every patch."""

    def __init__(self, dev):
        from particlesfm_tpu_torch.flow import infer
        from particlesfm_tpu_torch.io import checkpoint
        from particlesfm_tpu_torch.models.depth import DepthNet
        from particlesfm_tpu_torch.models.motionseg import TrajOADepth
        from particlesfm_tpu_torch.models.raft import RAFT
        from particlesfm_tpu_torch.ops import corr_lookup as cl
        from particlesfm_tpu_torch.pipeline import run as R

        self.seqs, self.builds, self.parsed, self._undo = [], {}, [], []
        self._patch(R, "run_pipeline", self._run(R.run_pipeline, cl))
        for name in ("_load_raft_apply", "_load_depth_apply", "_load_seg_apply"):
            self._patch(R, name, self._loader(getattr(R, name), dev))
        for cls, tag in ((RAFT, "raft"), (DepthNet, "depth"), (TrajOADepth, "seg")):
            self._patch(cls, "__init__", self._counted_init(cls.__init__, tag))
        parse = checkpoint.load_msgpack

        def counted_parse(path):
            self.parsed.append(Path(str(path)).name)
            return parse(path)

        self._patch(checkpoint, "load_msgpack", counted_parse)
        self._patch(infer, "load_msgpack", counted_parse)

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def restore(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)

    def _run(self, run_pipeline, cl):
        def run_one(img_dir, out_dir, cfg, log=print, device="cuda"):
            st = dict(name=Path(img_dir).parent.name, out_dir=Path(out_dir), msgs=[],
                      loader_s=0.0, device=device)
            self.seqs.append(st)
            k0, v0 = cl.launches, cl.vec_launches
            t0 = time.perf_counter()
            st["rec"] = run_pipeline(img_dir, out_dir, cfg, log=st["msgs"].append,
                                     device=device)
            st["wall"] = time.perf_counter() - t0
            st["launches"], st["vec_launches"] = cl.launches - k0, cl.vec_launches - v0
            return st["rec"]
        return run_one

    def _loader(self, fn, dev):
        import torch

        def timed(cfg, device):
            t0 = time.perf_counter()
            out = fn(cfg, device)
            torch.cuda.synchronize(dev)
            self.seqs[-1]["loader_s"] += time.perf_counter() - t0
            return out
        return timed

    def _counted_init(self, init, tag):
        def counted(obj, *a, **kw):
            self.builds[tag] = self.builds.get(tag, 0) + 1
            init(obj, *a, **kw)
        return counted


def phase_sweep(dev, dump_dir=None) -> dict:
    """Phase [sweep]: render hb_01_dyn (held-out family B) and seq_01_dyn
    (family A), 48 frames at 1024x436 each, run the user's `--root_dir`
    command in-process on the card, score it with the port's eval tools and
    look at it with its viewer and overlay tools. Returns the K1 launches
    of the run."""
    import torch

    from particlesfm_tpu_torch.eval import sintel
    from particlesfm_tpu_torch.eval.pose_eval import (evaluate_sequence, load_pose_dir,
                                                      read_sintel_cam, summarize)
    from particlesfm_tpu_torch.eval.traj_iou import trajectory_label_metrics
    from particlesfm_tpu_torch.io import colmap_model as cm
    from particlesfm_tpu_torch.io.avi import read_mjpeg_avi_frames
    from particlesfm_tpu_torch.io.images import load_image_stack
    from particlesfm_tpu_torch.motionseg.visualize import write_overlay_video
    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.pipeline import run as R
    from particlesfm_tpu_torch.pipeline import stages
    from particlesfm_tpu_torch.sfm import visualize
    from particlesfm_tpu_torch.tracks.store import TrackArrays
    from particlesfm_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    root = WORK / "sweep"
    h, w, T = SEQ["h"], SEQ["w"], FRAMES
    t0 = time.perf_counter()
    dyn = render_sweep(root, T, h, w)
    t_render = time.perf_counter() - t0
    log(f"[sweep] rendered {', '.join(SWEEP_SEQS)}: {T} frames each at {w}x{h} with .cam "
        f"poses and dynamic masks in {t_render:.1f}s (host pool)")

    # the user's command, as a fresh process runs it: no apply cached yet
    R._APPLY_CACHE.clear()
    probe = _SweepProbe(dev)
    try:
        cl.reset_launches()
        t0 = time.perf_counter()
        rc = R.main(["--root_dir", str(root / "seqs")])
        t_run = time.perf_counter() - t0
        launches = cl.launches
    finally:
        probe.restore()
    if rc != 0:
        fail(f"sweep: run_pipeline.main --root_dir returned {rc}")
    if [s["name"] for s in probe.seqs] != list(SWEEP_SEQS):
        fail(f"sweep: the --root_dir run took {[s['name'] for s in probe.seqs]}")
    if probe.builds != {"raft": 1, "depth": 1, "seg": 1}:
        fail(f"sweep: nets built {probe.builds} times over the two sequences (once each)")
    if sorted(probe.parsed) != sorted(p.name for p in (
            R.DEFAULT_RAFT_CKPT, R.DEFAULT_DEPTH_CKPT, R.DEFAULT_SEG_CKPT)):
        fail(f"sweep: checkpoints parsed {probe.parsed} (each once)")
    cfg = R.config_from_args(R.build_arg_parser().parse_args(       # the run's config
        ["--image_dir", "-", "--output_dir", "-"]))
    expect = math.ceil((2 * (T - 1) + 2 * (T - 2)) / cfg.flow.per_device) * cfg.flow.iters
    results, models = [], {}
    for st in probe.seqs:
        name, out = st["name"], st["out_dir"]
        if st["launches"] != expect or st["vec_launches"] != st["launches"]:
            fail(f"sweep: {name} launched K1 {st['launches']} times ({st['vec_launches']} "
                 f"16-byte), expected {expect}, all 16-byte")
        rec = st["rec"]
        reg = rec.registered
        model = out / "sfm" / "model"
        if not all((model / f).exists() for f in ("cameras.bin", "images.bin", "points3D.bin")):
            fail(f"sweep: {name} wrote no model bins")
        _, images, points = cm.read_model_binary(model)
        est = load_pose_dir(out / "colmap_outputs_converted" / "poses")
        n_reg = int(reg.sum())
        if n_reg < 3 or len(images) != n_reg or len(est) != n_reg:
            fail(f"sweep: {name}: {n_reg} registered, {len(images)} in images.bin, "
                 f"{len(est)} converted poses (>= 3, all equal)")
        if not (np.isfinite(rec.qvec[reg]).all() and np.isfinite(rec.tvec[reg]).all()
                and all(np.isfinite(P).all() for P in est.values())):
            fail(f"sweep: {name} has non-finite poses")
        gt = {p.stem: read_sintel_cam(p)[1] for p in sorted((root / "gt" / name).glob("*.cam"))}
        res = evaluate_sequence(est, gt, name, min_registered_ratio=0.0)
        results.append(evaluate_sequence(est, gt, name))
        timings = (out / "timings.txt").read_text().strip().splitlines()
        stage_s = {ln.split()[0]: float(ln.split()[1].rstrip("s")) for ln in timings[1:]}
        focal = json.loads((out / "selfcal.json").read_text())["focal"]
        gt_focal = float(read_sintel_cam(root / "gt" / name / "000000.cam")[0][0, 0])
        models[name] = (model, images, points)
        log(f"[sweep] {name}: run_pipeline {st['wall']:.2f}s, loaders {st['loader_s']:.3f}s; "
            f"stages {json.dumps(stage_s)}; K1 {st['launches']} launches; {n_reg}/{T} "
            f"registered, {len(points)} points; Sim3 ATE {res.ate:.5f}, RPE-t "
            f"{res.rpe_trans:.5f}, RPE-r {res.rpe_rot_deg:.4f} deg against the renderer; "
            f"selfcal focal {focal:.2f} px, BA focal {float(rec.params[0]):.2f} px (renderer "
            f"{gt_focal:.2f} px)")
    log(f"[sweep] --root_dir run {t_run:.2f}s; nets built {json.dumps(probe.builds)}, "
        f"checkpoints parsed {probe.parsed}; loaders {probe.seqs[0]['loader_s']:.3f}s for the "
        f"first sequence, {probe.seqs[1]['loader_s']:.3f}s for the second; K1 {launches} "
        f"launches")

    # score: the Sintel CLI on the run, and the motion labels against the masks
    t0 = time.perf_counter()
    sintel.main(["--gt_root", str(root / "gt"), "--pred_root", str(root / "seqs"),
                 "--seqs", *SWEEP_SEQS])
    ate_txt = root / "seqs" / "errors_ate.txt"
    if not ate_txt.exists():
        fail("sweep: eval.sintel wrote no errors_ate.txt")
    if ate_txt.read_text() != summarize(results) + "\n":
        fail(f"sweep: errors_ate.txt {ate_txt.read_text()!r} is not evaluate_sequence's "
             f"{summarize(results)!r}")
    log(f"[sweep] eval.sintel: errors_ate.txt equals evaluate_sequence on the same files: "
        f"{ate_txt.read_text().strip()!r}")
    labeled = {}
    for st in probe.seqs:
        name = st["name"]
        labeled[name] = TrackArrays.load(st["out_dir"] / "trajectories_labeled" / "tracks.npz")
        m = trajectory_label_metrics(labeled[name], dyn[name])
        log(f"[sweep] {name}: trajectory labels against the renderer's masks over "
            f"{int(m['num_images'])} images: IoU {m['iou']:.4f}, precision "
            f"{m['precision']:.4f}, recall {m['recall']:.4f}, F1 {m['f1']:.4f} "
            f"({labeled[name].num_tracks} tracks)")
    t_score = time.perf_counter() - t0

    # look: the viewer export of each model, the overlay of the held-out one
    t0 = time.perf_counter()
    for name, (model, images, points) in models.items():
        ply, html = root / f"{name}.ply", root / f"{name}.html"
        visualize.main(["-i", str(model), "-o", str(ply), "-w", str(html)])
        n_vert = int(re.search(r"element vertex (\d+)", ply.read_text()[:300]).group(1))
        if n_vert != len(points) + 5 * len(images):
            fail(f"sweep: {name}.ply has {n_vert} vertices, not {len(points)} points + 5 x "
                 f"{len(images)} cameras")
        b64 = re.search(r'b64f32\("([^"]*)"\)', html.read_text()).group(1)
        pos = np.frombuffer(base64.b64decode(b64), np.float32).reshape(-1, 3)
        xyz = np.asarray([p.xyz for p in points.values()], np.float32)
        if not np.array_equal(pos, xyz):
            fail(f"sweep: {name}.html's embedded positions are not the model's xyz")
        log(f"[sweep] sfm.visualize {name}: {n_vert} PLY vertices = {len(points)} points + 5 x "
            f"{len(images)} cameras; HTML ({html.stat().st_size / 1e6:.1f} MB) embeds the "
            f"model's {len(xyz)} xyz exactly")
    name = SWEEP_SEQS[0]
    frames_u8, _ = load_image_stack(root / "seqs" / name / "images")
    ov = root / "overlay" / name
    write_overlay_video(ov, frames_u8, labeled[name])
    back = read_mjpeg_avi_frames(ov / "motion_seg.avi")
    n_png = len(list(ov.glob("overlay_*.png")))
    if n_png != T or not (ov / "motion_seg.gif").exists() or len(back) != T or \
            any(f.shape != (h, w, 3) for f in back):
        fail(f"sweep: overlay of {name}: {n_png} PNGs, GIF "
             f"{(ov / 'motion_seg.gif').exists()}, AVI frames "
             f"{[f.shape for f in back[:2]]} x {len(back)}")
    t_look = time.perf_counter() - t0
    log(f"[sweep] overlay of {name}: {n_png} PNGs, motion_seg.gif "
        f"({(ov / 'motion_seg.gif').stat().st_size / 1e6:.1f} MB), motion_seg.avi read back "
        f"as {len(back)} frames of {w}x{h}")

    # trace: one 8-pair flow block under the port's torch.profiler context
    apply = R._load_raft_apply(cfg, torch.device(probe.seqs[0]["device"]))  # the run's
    stack = stages.upload_frame_stack(frames_u8, dev)
    trace_dir = root / "trace"
    with trace(str(trace_dir)):
        apply(stack, np.arange(8), np.arange(1, 9))
        torch.cuda.synchronize(dev)
    files = list(trace_dir.glob("*.json"))
    if len(files) != 1 or "corr_lookup_kernel" not in files[0].read_text():
        fail(f"sweep: the trace {[f.name for f in files]} does not name corr_lookup_kernel")
    log(f"[sweep] trace of one 8-pair flow block: {files[0].name} "
        f"({files[0].stat().st_size / 1e6:.1f} MB) names corr_lookup_kernel")

    if dump_dir is not None:
        for st in probe.seqs:
            name, lab = st["name"], labeled[st["name"]]
            d = Path(dump_dir) / f"sweep_{name}"
            d.mkdir(parents=True, exist_ok=True)
            work = _stage_dir(f"sweep_sub_{name}", st["out_dir"])
            rows = np.sort(np.random.default_rng(0).choice(
                lab.num_tracks, min(SFM_DUMP_TRACKS, lab.num_tracks), replace=False))
            sub = TrackArrays(xy=lab.xy[rows], mask=lab.mask[rows], labels=lab.labels[rows])
            sub.save(work / "tracks.npz")
            save_tracks_compressed(work / "tracks.npz", d / "tracks.npz")
            shutil.copy(st["out_dir"] / "selfcal.json", d / "selfcal.json")
            names = [f"{i:06d}.ppm" for i in range(T)]
            r = stages.sfm_stage(sub, h, w, work, cfg, dev, names, log=lambda *a: None)
            gt_w2c = np.stack([read_sintel_cam(root / "gt" / name / f"{i:06d}.cam")[1]
                               for i in range(T)])
            np.savez_compressed(
                d / "sweep.npz", sfm_sub_registered=r.registered, sfm_sub_qvec=r.qvec,
                sfm_sub_tvec=r.tvec, sfm_sub_params=r.params, sfm_hw=np.array([h, w]),
                sfm_gt_w2c=gt_w2c, sfm_gt_focal=np.float64(
                    read_sintel_cam(root / "gt" / name / "000000.cam")[0][0, 0]))
            log(f"[sweep] --dump: {len(rows)} of {lab.num_tracks} labeled tracks of {name} "
                f"(seed 0): {r.num_registered}/{T} registered on the card")
    log(f"[sweep] phase {time.perf_counter() - t_phase:.1f}s: render {t_render:.1f}s, "
        f"--root_dir run {t_run:.1f}s, score {t_score:.1f}s, viewer and overlay "
        f"{t_look:.1f}s")
    return dict(launches=launches)

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", metavar="DIR", default=None,
                    help="write the selfcal correspondences and draws, the slice's depth, "
                         "4 frames, the seg check's chunks and card logits and the SfM "
                         "stage's poses to DIR/slice_dump.npz, and a seeded subset of the "
                         "labeled tracks (tracks.npz, with the card's SfM poses on it in "
                         "the npz) and selfcal.json beside it, and the same for each "
                         "[sweep] sequence in DIR/sweep_<name>/, for "
                         "scripts/compare_chip_dump_with_jax.py")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import particlesfm_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from particlesfm_tpu_torch.ops import corr_lookup as cl
    from particlesfm_tpu_torch.tracks import optimize as lm

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    for mod, entry in ((cl, "corr_lookup_kernelILi4ELi4E"), (lm, "track_lm_kernel")):
        t0 = time.perf_counter()
        so = mod.load_library()
        log(f"[build] {mod.SOURCE.name} -> {Path(so._name).name} in "
            f"{time.perf_counter() - t0:.2f}s")
        ptxas = Path(so._name).with_suffix(".log")
        if ptxas.exists():
            for ln in ptxas_lines(ptxas.read_text(), entry):
                log(f"[build] {ln}")
                if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
                    fail(f"build: {entry} spills registers")

    k = phase_kernel(dev)
    k2 = phase_track_lm(dev)
    if WORK.exists():
        shutil.rmtree(WORK)
    try:
        s = phase_slice(dev, FRAMES, bool(args.dump))
        me = phase_mesh(dev, s, bool(args.dump))
        s["dump"].update(me["dump"])
        for key in ("flows", "tracks", "depths"):       # the card memory [mesh] needed
            s.pop(key)
        if args.dump:          # saved before [modes] too, so that its failure leaves the dump
            d = Path(args.dump)
            d.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(d / "slice_dump.npz", **s["dump"])
            shutil.copy(WORK / "sfm_subset" / "selfcal.json", d / "selfcal.json")
            save_tracks_compressed(WORK / "sfm_subset" / "tracks.npz", d / "tracks.npz")
        m = phase_modes(dev, s, bool(args.dump))
        if args.dump:
            s["dump"].update(m)
            np.savez_compressed(d / "slice_dump.npz", **s["dump"])
        kh = phase_net(dev, s["img_dir"], scale=0.5, tag="kernel-half")
        kn = phase_net(dev, s["img_dir"])
        tr = phase_train(dev)
        sw = phase_sweep(dev, args.dump)
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
        bound_ms_half=kh["bound_ms"], max_abs_err_half=kh["max_abs_err"],
        launches_train=tr["flow"]["launches"], ms_val=tr["flow"]["kernel"]["ms"],
        plain_ms_val=tr["flow"]["kernel"]["plain_ms"],
        library_ms_val=tr["flow"]["kernel"]["library_ms"],
        bound_ms_val=tr["flow"]["kernel"]["bound_ms"],
        max_abs_err_val=tr["flow"]["kernel"]["max_abs_err"], launches_sweep=sw["launches"],
        launches_mesh=me["launches"]),
        dict(name="track_lm", route="cuda", source="particlesfm_tpu_torch/csrc/track_lm.cu",
             replaces="none (step 4 of particlesfm_tpu/tracks/engine.py, left to XLA)",
             launches=s["lm_launches"], **k2)]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
