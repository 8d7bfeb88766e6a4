"""Smoke run of the PyTorch/CUDA port on one GPU: builds kernel K1, holds it
against its plain version, drives the port's main path and checks its output.

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --profile  # also device time by kernel of one more run

Phases (each prints one line; any failure exits non-zero):
  1. device  — CUDA required; card name and power limit from nvidia-smi.
  2. build   — nvcc builds csrc/corr_lookup.cu (sm_90a).
  3. kernel  — K1 vs the plain lookup at the main path's block shape
               (8 pairs, 55x128 level 0, 4 levels, r=4): max error, exact
               zeros out of range, and times (kernel, plain, F.grid_sample).
  4. slice   — renders the acceptance set's seq_03_dyn (seed 0, 1024x436,
               48 frames) and runs `run_pipeline --assume_static --skip_sfm
               --set flow.selfcal=false` on the card: K1 launch count, finite
               flows, stride-1 EPE against the renderer's ground truth, tracks.
  5. net     — one block of 8 pairs through RAFT with K1 and with the plain
               lookup on the card; the flows must agree.
The last two lines are the card's `name, power.limit` and
{"ok": true, "device": {...}}; the line before them lists the kernels.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
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
    """Worker: write frame i as PPM; return GT stride-1 flow i->i+1 if asked."""
    from PIL import Image

    i, frames, seq, img_dir, want_gt = job
    sc = _scene(frames, **seq)
    Image.fromarray(sc.render(i)).save(Path(img_dir) / f"{i:06d}.ppm")
    return i, (sc.gt_flow(i, i + 1) if want_gt else None)


def render_sequence(frames: int, img_dir: Path):
    img_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(i, frames, SEQ, str(img_dir), i < GT_PAIRS) for i in range(frames)]
    gt = {}
    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        for i, flow in pool.imap_unordered(_render_frame, jobs):
            if flow is not None:
                gt[i] = flow
    return np.stack([gt[i] for i in range(GT_PAIRS)])


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

def phase_kernel(dev, B=8, H8=55, W8=128):
    """K1 vs plain at the main path's block shape; times and the bound."""
    import torch
    import torch.nn.functional as F

    from particlesfm_tpu_torch.models.raft import build_corr_pyramid
    from particlesfm_tpu_torch.ops import corr_lookup as cl

    D, r = 128, 4
    P = H8 * W8
    g = torch.Generator(device=dev).manual_seed(0)
    f1 = torch.randn(B, D, H8, W8, generator=g, device=dev)
    f2 = torch.randn(B, D, H8, W8, generator=g, device=dev)
    pyr = build_corr_pyramid(f1, f2, 4)
    del f1, f2
    lo = torch.tensor([-2.0, -2.0], device=dev)
    hi = torch.tensor([W8 + 1.0, H8 + 1.0], device=dev)
    coords = lo + (hi - lo) * torch.rand(B, P, 2, generator=g, device=dev)
    far = torch.rand(B, P, generator=g, device=dev) < 0.1
    sign = torch.where(torch.rand(B, P, 1, generator=g, device=dev) < 0.5, 1.0, -1.0)
    coords = torch.where(far[..., None], sign * torch.tensor([1000.0, -1000.0], device=dev),
                         coords).contiguous()

    out_k = cl.lookup_corr_cuda(pyr, coords, r)
    out_p = cl.lookup_corr_plain(pyr, coords, r)
    max_err = float((out_k - out_p).abs().max())
    scale = float(pyr[0].abs().max())
    if not max_err <= 1e-5 * scale:
        fail(f"kernel: max |K1 - plain| {max_err} > 1e-5 * max|corr| ({scale})")
    if not bool((out_k[far] == 0).all()):
        fail("kernel: out-of-range rows are not exactly 0")

    ms = time_ms(lambda: cl.lookup_corr_cuda(pyr, coords, r))
    plain_ms = time_ms(lambda: cl.lookup_corr_plain(pyr, coords, r))

    # library yardstick: one F.grid_sample call per level (timed, never used)
    K = 2 * r + 1
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], -1)                            # [K, K, 2]
    grids, inputs = [], []
    for lvl, c in enumerate(pyr):
        Hl, Wl = c.shape[-2:]
        pts = coords.view(B * P, 1, 1, 2) / 2 ** lvl + delta       # [BP, K, K, 2]
        norm = torch.tensor([2.0 / (Wl - 1), 2.0 / (Hl - 1)], device=dev)
        grids.append(pts * norm - 1.0)
        inputs.append(c.view(B * P, 1, Hl, Wl))

    def library():
        return [F.grid_sample(x, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for x, gr in zip(inputs, grids)]

    out_l = torch.cat([o.view(B, P, K * K) for o in library()], -1)
    lib_err = float((out_l - out_p).abs().max())
    library_ms = time_ms(library)

    # bound: bytes this run's data needs (output + coords + every pixel's
    # in-map (2r+2)^2 window per level) over HBM bandwidth, vs ~13 flops
    # per output over the fp32 rate
    window_elems = 0
    for lvl, c in enumerate(pyr):
        Hl, Wl = c.shape[-2:]
        pt = coords / 2 ** lvl
        x0 = torch.floor(pt[..., 0]).clamp(-1e6, 1e6).long() - r
        y0 = torch.floor(pt[..., 1]).clamp(-1e6, 1e6).long() - r
        nx = (torch.minimum(x0 + 2 * r + 1, torch.tensor(Wl - 1, device=dev))
              - torch.clamp(x0, min=0) + 1).clamp(min=0)
        ny = (torch.minimum(y0 + 2 * r + 1, torch.tensor(Hl - 1, device=dev))
              - torch.clamp(y0, min=0) + 1).clamp(min=0)
        window_elems += int((nx * ny).sum())
    n_out = B * P * len(pyr) * K * K
    bytes_moved = 4 * (n_out + B * P * 2 + window_elems)
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 13 * n_out / FP32_FLOPS * 1e3
    res = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(bound_bytes_ms, bound_ops_ms),
               bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
               bytes=bytes_moved)
    log(f"[kernel] corr_lookup B={B} P={P} levels=4 r={r}: max|K1-plain| {max_err:.3e} "
        f"(max|corr| {scale:.3f}), out-of-range rows exactly 0; K1 {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms "
        f"(max|grid_sample-plain| {lib_err:.3e}); bound {res['bound_ms']:.4f} ms "
        f"({bytes_moved / 1e6:.1f} MB, {res['bound_by']}) -> "
        f"{100 * res['bound_ms'] / ms:.1f}% of bound")
    return res


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


def phase_slice(dev, frames: int, profile_run: bool = False):
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
        "--image_dir", str(img_dir), "--output_dir", str(out_dir),
        "--assume_static", "--skip_sfm", "--set", "flow.selfcal=false"])
    cfg = R.config_from_args(args)
    msgs = []
    flows = {}
    flow_stage = stages.flow_stage

    def kept_flow_stage(*a, **kw):
        # keep the flow stage's result (tensors on the card) to score it
        # after the timed run; the run itself writes no .flo files
        flows.update(flow_stage(*a, **kw))
        return flows

    stages.flow_stage = kept_flow_stage
    try:
        torch.cuda.reset_peak_memory_stats()
        cl.reset_launches()
        t0 = time.perf_counter()
        tracks = R.run_pipeline(img_dir, out_dir, cfg, log=msgs.append, device=dev)
        wall = time.perf_counter() - t0
        launches = cl.launches
    finally:
        stages.flow_stage = flow_stage
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_pairs = 2 * (frames - 1) + 2 * (frames - 2)
    blocks = math.ceil(n_pairs / cfg.flow.per_device)
    if launches != blocks * cfg.flow.iters:
        fail(f"slice: K1 launched {launches} times, expected {blocks} blocks x "
             f"{cfg.flow.iters} iterations")
    for name in ("flow_f", "flow_b", "flow_f2", "flow_b2"):
        if not bool(torch.isfinite(flows[name]).all()):
            fail(f"slice: non-finite values in {name}")
    epe = np.linalg.norm(flows["flow_f"][:GT_PAIRS].cpu().numpy() - gt, axis=-1)
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
    log(f"[slice] run_pipeline {wall:.2f}s: stages {json.dumps(stage_s)}; "
        f"{n_pairs} pairs in {blocks} blocks, net+refine {net_s:.3f}s = "
        f"{n_pairs / net_s:.2f} pairs/s; K1 launches {launches}; "
        f"stride-1 EPE median {epe_median:.4f} px, per-pair mean "
        f"{np.round(epe_mean_pairs, 4).tolist()}; {n_long} tracks of length >= 3 "
        f"over {tracks.num_frames} frames; peak allocated {peak_gb:.2f} GB")
    if profile_run:
        profile_pipeline(dev, img_dir, cfg)
    return dict(launches=launches, img_dir=img_dir)


def phase_net(dev, img_dir: Path):
    import torch
    import torch.nn.functional as F

    from particlesfm_tpu_torch.flow.infer import load_model
    from particlesfm_tpu_torch.io.images import load_image_stack
    from particlesfm_tpu_torch.ops.corr_lookup import lookup_corr, lookup_corr_plain
    from particlesfm_tpu_torch.pipeline.run import DEFAULT_RAFT_CKPT

    images, _ = load_image_stack(img_dir)
    n = min(8, len(images) - 1)               # one block of stride-1 pairs
    x = torch.from_numpy(images[:n + 1]).to(dev).permute(0, 3, 1, 2)
    x = F.pad(x, (0, (-x.shape[-1]) % 8, 0, (-x.shape[-2]) % 8), mode="replicate")
    x = x.permute(0, 2, 3, 1).contiguous()
    model, _ = load_model(DEFAULT_RAFT_CKPT, dev)
    with torch.inference_mode():
        model.lookup = lookup_corr
        fk = model(x[:n], x[1:], iters=8)
        model.lookup = lookup_corr_plain
        fp = model(x[:n], x[1:], iters=8)
    d = (fk - fp).abs()
    mean_d, max_d = float(d.mean()), float(d.max())
    if not (mean_d <= 1e-3 and max_d <= 1e-2):
        fail(f"net: K1 vs plain flows differ by mean {mean_d} / max {max_d} px")
    log(f"[net] RAFT block of {n} pairs at {x.shape[2]}x{x.shape[1]}: K1 vs plain lookup "
        f"flow |diff| mean {mean_d:.3e} px, max {max_d:.3e} px")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more pipeline run (device time by kernel)")
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
        for ln in ptxas.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {ln.strip()}")

    k = phase_kernel(dev)
    if WORK.exists():
        shutil.rmtree(WORK)
    try:
        s = phase_slice(dev, FRAMES, args.profile)
        phase_net(dev, s["img_dir"])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    kernels = [dict(
        name="corr_lookup", route="cuda",
        source="particlesfm_tpu_torch/csrc/corr_lookup.cu",
        replaces="particlesfm_tpu/ops/corr_lookup.py:62",
        launches=s["launches"], max_abs_err=k["max_abs_err"], ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
        library_ms=k["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
