"""The control comes out not correct: the references in TF32 (one precision
below the configuration's float32 with TF32 off) and the tracker on bfloat16
flows, put in the program's place, fail a limit that the program passes. On
a card only: TF32 does not exist on the CPU. Cut to 12 frames at 192x320 so
that a test run holds it; the readings the limits were set from are the
cells' own sizes (`calibrate.py`)."""
import pytest
import torch

import run
from bench_judge import Judge, verdict
from bench_scenes import render_sequence, seeded_rng
from bench_window import Capture, Hooks
from run import CODE_ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sintel.full", "scannet.static"])
def test_control_fails_a_limit_the_program_passes(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from particlesfm_tpu_torch.ops import corr_lookup
    from particlesfm_tpu_torch.pipeline import run as run_mod

    corr_lookup.load_library()
    cell = run.load_cell(CODE_ROOT, workload, False)
    cell.traffic["flags"] = list(cell.traffic["flags"]) + ["--skip_sfm"]    # nets only
    cfg = run.build_cfg(cell, "cuda:0")
    judge = Judge(CODE_ROOT, cell.config, torch.device("cuda", 0))
    recipe = dict(cell.traffic["scene"], focal_factor=cell.config["focal_factor"])
    limits = {k: v for k, v in cell.config["limits"].items() if not k.startswith("poses.")}
    flags = cell.flags
    hooks = Hooks()
    hooks.install_captures()
    try:
        for seed in (1, 2, 3):
            seq = render_sequence(seeded_rng(seed, 0, 0), recipe, 12, 192, 320,
                                  tmp_path / f"s{seed}", "cuda:0")
            cap = Capture(seeded_rng(seed, 2, 0), 8, 8, tracks=True)
            hooks.cap = cap
            run_mod.run_pipeline(seq.image_dir, tmp_path / f"o{seed}", cfg, log=lambda m: None,
                                 device="cuda:0")
            hooks.cap = None
            ok, rows = verdict(judge.numbers(cap, seq), limits, flags)
            assert ok, rows
            ok, rows = verdict(judge.numbers(cap, seq, control=True), limits, flags)
            assert not ok, rows
    finally:
        hooks.restore()
        run_mod._APPLY_CACHE.clear()
