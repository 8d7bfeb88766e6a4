"""Rules of the port: no JAX at import, CUDA or an explicit CPU request, and
no silent skipping of stages the port does not have yet."""
import ast
from pathlib import Path

import pytest
import torch

import particlesfm_tpu_torch
from particlesfm_tpu_torch.flow.infer import load_flow_apply_pairs
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.pipeline.run import DEFAULT_RAFT_CKPT
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PKG = Path(particlesfm_tpu_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "optax", "particlesfm_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) > 20
    for mod in ("native.py", "graph/viewgraph.py", "sfm/mapper.py", "sfm/manager.py",
                "sfm/export.py", "sfm/correspondences.py", "globalsfm/ba.py",
                "globalsfm/translation.py", "io/colmap_model.py", "eval/pose_eval.py"):
        assert PKG / mod in files, mod
    bad = {f"{f.relative_to(PKG.parent)}: {m}" for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _args(tmp_path, *extra):
    return run.build_arg_parser().parse_args(
        ["--image_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"), *extra])


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = run.config_from_args(_args(tmp_path, "--assume_static", "--skip_sfm",
                                     "--set", "flow.selfcal=false"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.run_pipeline(tmp_path, tmp_path / "out", cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_flow_apply_pairs(DEFAULT_RAFT_CKPT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--image_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                  "--assume_static", "--skip_sfm", "--set", "flow.selfcal=false"])
    assert load_flow_apply_pairs(DEFAULT_RAFT_CKPT, device="cpu").refines is False


@pytest.mark.parametrize("extra,stage", [
    (("--sfm_type", "incremental"), "incremental SfM"),
    (("--set", "sfm.position.method=linear"), "linear position"),
    (("--set", "sfm.position.method=nonlinear"), "nonlinear position"),
    (("--assume_static", "--skip_sfm", "--set", "flow.selfcal=false",
      "--set", "flow.stride2_compose_disagree_px=4.0"), "stride-2 composition"),
])
def test_unported_stages_raise(tmp_path, extra, stage):
    cfg = run.config_from_args(_args(tmp_path, *extra))
    with pytest.raises(NotImplementedError, match=stage):
        run.run_pipeline(tmp_path, tmp_path / "out", cfg, device="cpu")
    assert not (tmp_path / "out").exists()          # raised before any work


@pytest.mark.parametrize("extra", [
    (),
    ("--sfm_type", "glomap"),
    ("--set", "sfm.position.method=glomap"),
    ("--set", "sfm.multiple_models=false"),
    ("--assume_static", "--set", "flow.selfcal=false"),
    ("--skip_sfm", "--sfm_type", "incremental", "--set", "sfm.position.method=linear"),
])
def test_require_ported_accepts_every_ported_configuration(tmp_path, extra):
    """require_ported raises only for incremental SfM, linear/nonlinear
    positions and the stride-2 composition fallback; the default command
    and the other SfM modes pass (SfM options are moot with --skip_sfm)."""
    from particlesfm_tpu_torch.pipeline.stages import require_ported

    require_ported(run.config_from_args(_args(tmp_path, *extra)))


def test_reduced_resolution_flow_raises():
    with pytest.raises(NotImplementedError, match="infer_scale"):
        load_flow_apply_pairs(DEFAULT_RAFT_CKPT, scale=0.5, device="cpu")


def test_skip_sfm_runs_every_ported_stage_on_cpu(tmp_path):
    """The default command with --skip_sfm: selfcal.json, the labeled tracks
    and the four stage timers; depth/ and optical_flows/ are removed."""
    import json

    import numpy as np
    from PIL import Image

    from particlesfm_tpu_torch.synth import random_scene

    sc = random_scene(np.random.default_rng(0), num_views=5, height=64, width=96,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)
    (tmp_path / "img").mkdir()
    for i in range(5):
        Image.fromarray(sc.render(i)).save(tmp_path / "img" / f"{i:06d}.png")
    out = tmp_path / "out"
    assert run.main(["--image_dir", str(tmp_path / "img"), "--output_dir", str(out),
                     "--skip_sfm", "--skip_path_consistency", "--sample_ratio", "4",
                     "--set", "track.capacity=2048", "--device", "cpu"]) == 0
    assert set(json.loads((out / "selfcal.json").read_text())) == {
        "focal", "confidence", "num_pairs", "dip", "interior"}
    lab = np.load(out / "trajectories_labeled" / "tracks.npz")
    assert lab["labels"].shape == lab["mask"].shape and lab["mask"].sum() > 0
    timings = (out / "timings.txt").read_text()
    for stage in ("flow", "trajectories", "depth", "motion_seg"):
        assert stage in timings
    assert not (out / "depth").exists() and not (out / "optical_flows").exists()
