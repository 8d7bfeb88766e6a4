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
    ((), "flow self-calibration"),
    (("--set", "flow.selfcal=false"), "depth \\+ motion segmentation"),
    (("--assume_static", "--set", "flow.selfcal=false"), "global SfM"),
    (("--assume_static", "--skip_sfm", "--set", "flow.selfcal=false",
      "--set", "flow.stride2_compose_disagree_px=4.0"), "stride-2 composition"),
])
def test_unported_stages_raise(tmp_path, extra, stage):
    cfg = run.config_from_args(_args(tmp_path, *extra))
    with pytest.raises(NotImplementedError, match=stage):
        run.run_pipeline(tmp_path, tmp_path / "out", cfg, device="cpu")
    assert not (tmp_path / "out").exists()          # raised before any work


def test_reduced_resolution_flow_raises():
    with pytest.raises(NotImplementedError, match="infer_scale"):
        load_flow_apply_pairs(DEFAULT_RAFT_CKPT, scale=0.5, device="cpu")
