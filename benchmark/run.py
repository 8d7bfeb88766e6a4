#!/usr/bin/env python3
"""The benchmark of particlesfm_tpu_torch: whole sequences through
`pipeline.run.run_pipeline` on the card, back to back, as a `--root_dir`
sweep runs them.

    python3 benchmark/run.py --workload sintel.full --seed 7 --seconds 45 --trace 0

Set-up renders the traffic's fixed pool of scenes on the device, writes their
frames as PPM files under TMPDIR and runs one short warm-up sequence at the
cell's shapes; the seed draws what `correct` samples. The window then runs
the pool's sequences in turn and closes at the end of the first whole pass
over the pool that ends after `--seconds` have passed, so every window holds
each scene equally often.
Afterwards what the timed path produced is held against the plain references
(`bench_judge.py`), and one JSON line is printed last on stdout. With
`--trace 1` the window runs under torch.profiler and the line carries the
cell's per-layer metrics and a breakdown instead of the end-to-end ones.

Cells, configurations, traffic mixes and metrics are found by name: see
README.md beside this file.
"""
from __future__ import annotations

import os
import sys
import time

_WALL0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CODE_ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "particlesfm_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _WALL0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="'cpu' rehearses the harness at a tiny size; results name the platform")
    return p.parse_args(argv)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list                 # BENCHMARK.json entries this run reports

    @property
    def flags(self) -> list:
        return list(self.config.get("flags", [])) + list(self.traffic.get("flags", []))


def load_cell(root: Path, name: str, trace: bool) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if name in m.get("workloads", [name])]
    return Cell(name, int(w["chips"]), config, traffic, metrics)


def load_reader(name: str):
    """benchmark/metrics/<name>.py as a module."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Ctx:
    """What a metric's reader reads."""
    cell: Cell
    device: object
    trace: bool
    recording: bool = False       # inside the measured window
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    frames_done: int = 0
    peak_bytes: int = 0
    done: list = field(default_factory=list)        # (sequence, capture, out_dir)
    span_s: dict = field(default_factory=dict)      # span name -> [host seconds]
    events: dict = None           # bench_trace.reduce_trace of the window
    window_ns: tuple = None
    busy_s: float = 0.0
    stash: dict = field(default_factory=dict)       # readers' own records
    root: Path = CODE_ROOT        # the checkout: checkpoints/

    @property
    def sequences(self) -> int:
        return len(self.done)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_cfg(cell: Cell, device: str):
    from particlesfm_tpu_torch.pipeline.run import build_arg_parser, config_from_args

    return config_from_args(build_arg_parser().parse_args(cell.flags + ["--device", device]))


def render_pool(cell: Cell, work: Path, dev):
    """The pool's sequences and the warm-up sequence, rendered on `dev`. The
    scenes are the traffic's fixed set (drawn from its `scene_seed`) in a
    fixed order, so that every run's window does the same work; the run's
    seed draws only what `correct` samples."""
    from bench_scenes import render_sequence, seeded_rng

    cfg, tr = cell.config, cell.traffic
    recipe = dict(tr["scene"], focal_factor=cfg["focal_factor"])
    H, W, T = cfg["height"], cfg["width"], cfg["frames"]
    pool = [render_sequence(seeded_rng(tr["scene_seed"], 0, i), recipe, T, H, W,
                            work / f"scene{i}", dev) for i in range(tr["pool"])]
    warm = render_sequence(seeded_rng(tr["scene_seed"], 1), recipe, tr["warmup_frames"], H, W,
                           work / "warmup", dev)
    return pool, warm


def gave_result(res, flags) -> bool:
    if res is None:
        return False
    if "--skip_sfm" in flags:
        return int(res.num_tracks) > 0
    return int(res.num_registered) > 0


def run_cell(args, root: Path = CODE_ROOT, log=None) -> tuple:
    """Set-up, window, readers, judge. Returns (result dict, ctx, exit code)."""
    import torch

    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell = load_cell(root, args.workload, bool(args.trace))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            log("benchmark: CUDA is not available")
            return None, None, 3
        if torch.cuda.device_count() < cell.chips:
            log(f"benchmark: {cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} visible")
            return None, None, 3
        dev = torch.device("cuda", 0)

    import bench_trace
    from bench_judge import Judge, pose_numbers, verdict, worst
    from bench_scenes import seeded_rng
    from bench_window import Capture, Hooks

    from particlesfm_tpu_torch import native
    from particlesfm_tpu_torch.pipeline import run as run_mod

    ctx = Ctx(cell, dev, bool(args.trace))
    if dev.type == "cuda":
        from particlesfm_tpu_torch.ops import corr_lookup

        corr_lookup.load_library()
    native.ensure_built()
    readers = {m["name"]: load_reader(m["name"]) for m in cell.metrics}
    hooks = Hooks()
    if ctx.trace:
        for r in readers.values():
            for span, target in getattr(r, "SPANS", {}).items():
                if span not in ctx.span_s:
                    hooks.add_span(span, target, ctx.span_s, lambda: _sync(dev))
    hooks.install_captures()
    for r in readers.values():
        if hasattr(r, "install"):
            r.install(ctx)

    pdev = str(dev)
    cfg = build_cfg(cell, pdev)
    tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = Path(tempfile.mkdtemp(prefix="pfbench-", dir=tmp_root))
    tail = collections.deque(maxlen=40)
    errors = []
    try:
        log(f"set-up: imports and libraries {process_age_s():.2f} s")
        pool, warm = render_pool(cell, work, dev)
        log(f"set-up: pool rendered and written {process_age_s():.2f} s")
        run_mod.run_pipeline(warm.image_dir, work / "out_warmup", cfg, log=tail.append,
                             device=pdev)
        log(f"set-up: warm-up sequence done {process_age_s():.2f} s")
        shutil.rmtree(work / "out_warmup", ignore_errors=True)
        for v in ctx.span_s.values():
            v.clear()
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.setup_s = process_age_s()

        prof = bench_trace.Profiler(dev.type == "cuda") if ctx.trace else None
        if prof is not None:
            prof.start()
        ctx.recording = True
        t0 = time.perf_counter()
        # the one sequence of the window whose trajectories are checked
        track_k = int(seeded_rng(args.seed, 3).integers(len(pool)))
        with torch.profiler.record_function("bench.window"):
            k = 0
            while True:
                seq = pool[k % len(pool)]
                tr = cell.traffic["check"]
                cap = Capture(seeded_rng(args.seed, 2, k), tr["flow_pairs"], tr["depth_frames"],
                              tracks=k == track_k)
                out = work / "out" / f"{k:04d}"
                hooks.cap = cap
                ok, res = False, None
                ts = time.perf_counter()
                with torch.profiler.record_function("bench.sequence"):
                    try:
                        res = run_mod.run_pipeline(seq.image_dir, out, cfg, log=tail.append,
                                                   device=pdev)
                        ok = gave_result(res, cell.flags)
                        if not ok:
                            errors.append(f"sequence {k}: no model")
                    except Exception:          # a failed sequence counts, the window goes on
                        errors.append(f"sequence {k}: " + traceback.format_exc(limit=8))
                    del res
                hooks.cap = None
                log(f"sequence {k} ({seq.image_dir.name}): {time.perf_counter() - ts:.3f} s, "
                    f"{'ok' if ok else 'FAILED'}")
                ctx.attempted += 1
                if ok:
                    ctx.done.append((seq, cap, out))
                    ctx.frames_done += seq.scene.num_views
                else:
                    ctx.failed += 1
                k += 1
                if k % len(pool) == 0 and time.perf_counter() - t0 >= args.seconds:
                    break
            _sync(dev)
        ctx.window_s = time.perf_counter() - t0
        ctx.recording = False
        if dev.type == "cuda":
            ctx.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        if prof is not None:
            events = prof.stop()
            ctx.window_ns = bench_trace.window_bounds(events)
            ctx.events = bench_trace.reduce_trace(events, ctx.window_ns)
            ctx.busy_s = sum(t - s for s, t in bench_trace.busy_intervals(ctx.events["device"])) / 1e9
            del events

        metrics = {}
        for m in cell.metrics:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

        # the program's state goes before the references run
        hooks.restore()
        run_mod._APPLY_CACHE.clear()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        judge = Judge(CODE_ROOT, cell.config, dev)
        readings = []
        for seq, cap, out in ctx.done:
            r = judge.numbers(cap, seq)
            if "--skip_sfm" not in cell.flags:
                r.update(pose_numbers(out, seq))
            log(f"checked {seq.image_dir.name}: {json.dumps(r)}")
            if (out / "timings.txt").exists():
                log(" ".join((out / "timings.txt").read_text().split()))
            readings.append(r)
        written = sum(f.stat().st_size for f in work.rglob("*") if f.is_file())
        log(f"files under the work directory at the end: {written / 1e9:.3f} GB")
        numbers = worst(readings)
        ok, rows = verdict(numbers, cell.config["limits"], cell.flags)
        correct = bool(ok and ctx.failed == 0 and ctx.done)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips if dev.type == "cuda" else 1,
              "memory_peak_bytes": ctx.peak_bytes}
    if dev.type == "cuda":
        device["power_limit_w"] = power_limit()
        log(f"card: {device['kind']}, power limit {device['power_limit_w']} W")
    if ctx.trace:
        device["busy_s"] = ctx.busy_s
        device["window_s"] = (ctx.window_ns[1] - ctx.window_ns[0]) / 1e9
    result = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": device}
    if ctx.trace and ctx.events is not None:
        busy = bench_trace.busy_intervals(ctx.events["device"])
        gaps = bench_trace.idle_gaps(busy, ctx.window_ns, ctx.events["spans"])
        result["breakdown"] = bench_trace.breakdown(ctx.events["device"], gaps)
    for e in errors:
        log(e)
    if errors:
        log("program log tail:\n" + "\n".join(str(x) for x in tail))
    for name, v, lim in rows:
        log(f"check {name} = {v!r} (limit {lim})")
    result["limits"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, ctx, 0


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, root: Path = CODE_ROOT) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(HERE / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / "_cache" / "torch_extensions")
    result, _, code = run_cell(args, root)
    if code:
        return code
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(HERE), str(CODE_ROOT)]
    raise SystemExit(main())
