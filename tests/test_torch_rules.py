"""Rules of the port: no JAX at import, CUDA or an explicit CPU request, and
every option the JAX CLI accepts runs (no stage is refused or skipped)."""
import ast
from pathlib import Path

import numpy as np
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
                "globalsfm/translation.py", "io/colmap_model.py", "eval/pose_eval.py",
                "synth/family_b.py", "eval/traj_iou.py", "eval/plots.py", "eval/sintel.py",
                "eval/scannet.py", "eval/__init__.py", "io/avi.py", "motionseg/visualize.py",
                "sfm/colors.py", "sfm/html_viewer.py", "sfm/visualize.py", "utils/timer.py",
                "utils/__init__.py", "utils/profiling.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/sharded_ba.py"):
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


def test_mesh_needs_cuda_unless_devices_are_given(monkeypatch):
    """make_mesh() covers every visible card and raises without one; a mesh
    of given devices (repeats allowed) needs no CUDA."""
    from particlesfm_tpu_torch.parallel import make_mesh, mesh_for

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_for("cuda")
    assert make_mesh(devices=["cpu"] * 3).key() == ("cpu",) * 3
    assert mesh_for("cpu").key() == ("cpu",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().key() == ("cuda:0", "cuda:1")
    assert mesh_for("cuda").key() == ("cuda:0", "cuda:1")
    assert mesh_for("cuda:1").key() == ("cuda:1",)


def test_init_distributed_defaults_to_nccl(monkeypatch):
    import torch.distributed as dist

    from particlesfm_tpu_torch.parallel import init_distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    init_distributed()
    init_distributed("host:1234", 2, 1)
    assert calls == [dict(backend="nccl", init_method="env://"),
                     dict(backend="nccl", init_method="tcp://host:1234", world_size=2, rank=1)]


def test_trainers_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """The three training entry points raise without CUDA unless the CPU
    is asked for; none falls back."""
    from particlesfm_tpu_torch.depth import train as depth_train
    from particlesfm_tpu_torch.flow import train as flow_train
    from particlesfm_tpu_torch.motionseg import train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in ((flow_train.main, ["--out", str(tmp_path / "f.msgpack")]),
                       (depth_train.main, ["--out", str(tmp_path / "d.msgpack")]),
                       (train_cli.main, ["--synthetic", "--out_dir", str(tmp_path / "s")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)


# SfM options once refused by the port, each run on a ground-truth flow
# scene (tests/flow_scenes.py, as tests/test_torch_sfm_slice.py runs it)
SFM_OPTIONS = [
    ("--sfm_type", "incremental"),
    ("--sfm_type", "incremental", "--set", "sfm.ba.refine_focal_length=false"),
    ("--set", "sfm.position.method=linear"),
    ("--set", "sfm.position.method=linear", "--set", "sfm.multiple_models=false"),
    ("--set", "sfm.position.method=linear", "--set", "sfm.position.use_scale_constraints=false"),
    ("--set", "sfm.position.method=nonlinear"),
    ("--set", "sfm.position.method=nonlinear", "--set", "sfm.multiple_models=false"),
    ("--set", "sfm.position.method=nonlinear", "--set", "sfm.position.use_scale_constraints=false"),
]
SFM_EVIDENCE = {"incremental": "[incremental] done: ", "linear": "linear (spectral) position",
                "nonlinear": "nonlinear position refinement"}


@pytest.fixture(scope="module")
def flow_scene(tmp_path_factory):
    from flow_scenes import make_flow_scene
    from particlesfm_tpu_torch.io import flo
    from PIL import Image

    root = tmp_path_factory.mktemp("gt_flow")
    sc = make_flow_scene(num_views=8)
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    for i in range(sc["num_views"]):
        Image.fromarray(rng.integers(0, 255, (sc["height"], sc["width"], 3), dtype=np.uint8)
                        ).save(root / "images" / f"{i:06d}.png")
    for key, flows in sc["flows"].items():
        (root / "flows" / key).mkdir(parents=True)
        for i, f in enumerate(flows):
            flo.write_flo(root / "flows" / key / f"{i:06d}.flo", f)
    return root, sc


@pytest.mark.parametrize("extra", SFM_OPTIONS)
def test_formerly_refused_sfm_options_run_on_cpu(flow_scene, tmp_path, extra):
    """Each SfM option the port once refused runs through run_pipeline on
    the CPU from the CLI parser: every frame registered within 0.05 of the
    span of the ground truth (Sim3), the model bins, converted poses and
    stats written, and the option's own stage in the log."""
    import shutil

    from particlesfm_tpu_torch.geometry import alignment, se3
    from particlesfm_tpu_torch.io import colmap_model as cm

    root, sc = flow_scene
    out = tmp_path / "out"
    shutil.copytree(root / "flows", out / "optical_flows")
    cfg = run.config_from_args(run.build_arg_parser().parse_args(
        ["--image_dir", str(root / "images"), "--output_dir", str(out), "--assume_static",
         "--skip_exists", "--sample_ratio", "4", "--set", "track.capacity=8192", *extra]))
    logs = []
    rec = run.run_pipeline(root / "images", out, cfg, log=logs.append, device="cpu")
    words = [w.split("=")[-1] for w in extra]
    for key, line in SFM_EVIDENCE.items():
        if key in words:
            assert any(line in m for m in logs), key
    n = sc["num_views"]
    assert rec.num_registered == n
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    c = se3.camera_center(torch.as_tensor(rec.qvec), torch.as_tensor(rec.tvec)).numpy()
    assert alignment.ate_rmse(c, sc["centers"]) < 0.05 * span
    _, images, points = cm.read_model_binary(out / "sfm" / "model")
    assert len(images) == n and len(points) > 100
    # the incremental mode writes one model, no numbered model directories
    assert (out / "sfm" / "model" / "0").exists() == (
        "incremental" not in words and cfg.sfm.multiple_models)
    assert len(list((out / "colmap_outputs_converted" / "poses").glob("*.txt"))) == n
    assert (out / "sfm" / "stats.txt").read_text().startswith(f"Registered images: {n}")


# flow options once refused by the port, on a rendered 128x192 sequence
# (the half-scale net keeps RAFT's 4 pyramid levels at 64x96)
FLOW_OPTIONS = [
    ("--set", "flow.infer_scale=0.5"),
    ("--set", "flow.stride2_compose_disagree_px=4.0"),
    ("--set", "flow.infer_scale=0.5", "--set", "flow.stride2_compose_disagree_px=4.0"),
    ("--set", "flow.infer_scale=0.5", "--set", "flow.stride2_compose_disagree_px=0.25",
     "--keep_intermediate"),
]


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    from PIL import Image

    from particlesfm_tpu_torch.synth import random_scene

    root = tmp_path_factory.mktemp("rendered")
    sc = random_scene(np.random.default_rng(3), num_views=5, height=128, width=192,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=4, num_dynamic=1)
    (root / "img").mkdir()
    for i in range(5):
        Image.fromarray(sc.render(i)).save(root / "img" / f"{i:06d}.png")
    return root / "img", sc


@pytest.mark.parametrize("extra", FLOW_OPTIONS)
def test_formerly_refused_flow_options_run_on_cpu(rendered, tmp_path, extra):
    """Reduced-resolution flow and the stride-2 composition fallback run
    through run_pipeline on the CPU: finite flows of the frames' size whose
    stride-1 EPE against the renderer stays under 1.5 px (median), the
    fallback's log line when it engages, the tracks, selfcal.json and the
    stage timers written (with --keep_intermediate, the .flo files)."""
    from particlesfm_tpu_torch.io.flo import read_flo

    img, sc = rendered
    out = tmp_path / "out"
    cfg = run.config_from_args(run.build_arg_parser().parse_args(
        ["--image_dir", str(img), "--output_dir", str(out), "--assume_static", "--skip_sfm",
         "--set", "track.capacity=4096", *extra]))
    logs = []
    kept = {}
    flow_stage = run.stages.flow_stage

    def keep(*a, **kw):
        kept.update(flow_stage(*a, **kw))
        return kept
    run.stages.flow_stage = keep
    try:
        tracks = run.run_pipeline(img, out, cfg, log=logs.append, device="cpu")
    finally:
        run.stages.flow_stage = flow_stage
    for name, n in (("flow_f", 4), ("flow_b", 4), ("flow_f2", 3), ("flow_b2", 3)):
        assert tuple(kept[name].shape) == (n, 128, 192, 2)
        assert bool(torch.isfinite(kept[name]).all())
    gt = np.stack([sc.gt_flow(i, i + 1) for i in range(4)])
    assert np.median(np.linalg.norm(kept["flow_f"].numpy() - gt, axis=-1)) < 1.5
    engaged = [m for m in logs if "composed-stride-1 fallback" in m]
    if 0 < cfg.flow.stride2_compose_disagree_px < 1:
        assert engaged
    if cfg.flow.stride2_compose_disagree_px == 0:
        assert not engaged
    assert tracks.num_tracks > 100
    assert (out / "selfcal.json").exists() and (out / "trajectories" / "tracks.npz").exists()
    assert "flow" in (out / "timings.txt").read_text()
    flo_dir = out / "optical_flows" / "flow_f2"
    assert flo_dir.is_dir() == cfg.keep_intermediate
    if cfg.keep_intermediate:
        assert read_flo(sorted(flo_dir.glob("*.flo"))[0]).shape == (128, 192, 2)


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
