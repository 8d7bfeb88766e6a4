#!/usr/bin/env python3
"""The readings the limits of `correct` are set from. For each cell and each
scene of its traffic's fixed pool (or other scenes of the same recipe, by
index), the scene runs through the program with the captures the benchmark
takes, once per mode:

- `program`: the program as the benchmark runs it (the lower readings), with
  the control's numbers beside it (the references in TF32 and the tracker on
  bfloat16 flows, in the program's place: the upper readings);
- `program_tf32`: the program with TF32 on, the control of the poses;
- a fault of `bench_faults.py` (e.g. `ba_skipped`, `lm_one_step`): the
  program with that fault planted.

One JSON line per scene and mode.

    python3 benchmark/calibrate.py --workload sintel.full --scenes 0-3 \\
        --modes program,program_tf32,ba_skipped,lm_one_step --seed 11 \\
        --out chiprun_out/cal_sintel.jsonl

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402


def ints_arg(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--scenes", type=ints_arg, default=None,
                   help="scene indices of the traffic's recipe (default: its pool)")
    p.add_argument("--modes", default="program")
    p.add_argument("--seed", type=int, default=11, help="draws the checked samples")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(run.CODE_ROOT), help="where BENCHMARK.json is")
    args = p.parse_args(argv)

    import pytest
    import torch

    from bench_faults import FAULTS
    from bench_judge import Control, Judge, pose_numbers
    from bench_scenes import render_sequence, seeded_rng
    from bench_window import Capture, Hooks
    from particlesfm_tpu_torch import native
    from particlesfm_tpu_torch.pipeline import run as run_mod

    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    if dev.type == "cuda":
        from particlesfm_tpu_torch.ops import corr_lookup

        corr_lookup.load_library()
    native.ensure_built()
    hooks = Hooks()
    hooks.install_captures()
    modes = args.modes.split(",")
    work = Path(tempfile.mkdtemp(prefix="pfbench-cal-"))
    out = open(args.out, "a")
    try:
        for name in args.workload:
            cell = run.load_cell(Path(args.root), name, False)
            cfg = run.build_cfg(cell, str(dev))
            judge = Judge(run.CODE_ROOT, cell.config, dev)
            c, tr = cell.config, cell.traffic
            recipe = dict(tr["scene"], focal_factor=c["focal_factor"])
            sfm = "--skip_sfm" not in cell.flags
            for i in args.scenes if args.scenes is not None else range(tr["pool"]):
                seq = render_sequence(seeded_rng(tr["scene_seed"], 0, i), recipe, c["frames"],
                                      c["height"], c["width"], work / "seq", dev)
                for mode in modes:
                    row = {"workload": name, "scene": i, "mode": mode, "seed": args.seed}
                    cap = Capture(seeded_rng(args.seed, 2, i), tr["check"]["flow_pairs"],
                                  tr["check"]["depth_frames"], tracks=True)
                    with pytest.MonkeyPatch.context() as mp:
                        if mode in FAULTS:
                            FAULTS[mode](mp)
                            mp.setattr(run_mod, "_APPLY_CACHE", {})
                        elif mode not in ("program", "program_tf32"):
                            raise SystemExit(f"unknown mode {mode}")
                        prec = Control.tf32() if mode == "program_tf32" \
                            else contextlib.nullcontext()
                        hooks.cap = cap
                        t0 = time.perf_counter()
                        with prec:
                            res = run_mod.run_pipeline(seq.image_dir, work / "out", cfg,
                                                       log=lambda m: None, device=str(dev))
                        hooks.cap = None
                        row["s"] = time.perf_counter() - t0
                        row["ok"] = run.gave_result(res, cell.flags)
                    r = judge.numbers(cap, seq) if mode in ("program", "program_tf32") else {}
                    if sfm:
                        r.update(pose_numbers(work / "out", seq))
                    row["numbers"] = r
                    if mode == "program":
                        row["control"] = judge.numbers(cap, seq, control=True)
                    shutil.rmtree(work / "out", ignore_errors=True)
                    print(json.dumps(row), file=out, flush=True)
                    print(json.dumps(row), flush=True)
                shutil.rmtree(work / "seq", ignore_errors=True)
    finally:
        out.close()
        hooks.restore()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
