"""Port parity, end to end with SfM: both packages' default `run_pipeline`
(no --skip_sfm) on a ground-truth flow scene (tests/flow_scenes.py, as
tests/test_pipeline.py runs it), and stage mixing: the reference's
tracks.npz in, the port's model out.

Tolerances: the same registered frames; the port's camera centers within
Sim3 ATE 1e-3 of the span of the reference's (the LUD scale gauge differs by
ADMM's loose stop, which Sim3 removes); both within the reference test's
0.05-of-span bound of the ground truth; focal within 1e-3 relative; the
stats files report the same registered count.
"""
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from particlesfm_tpu.io import flo as jflo
from particlesfm_tpu.pipeline import run as jrun
from particlesfm_tpu_torch.eval.pose_eval import evaluate_sequence, load_pose_dir
from particlesfm_tpu_torch.geometry import alignment, se3
from particlesfm_tpu_torch.io import colmap_model as cm
from particlesfm_tpu_torch.pipeline import run

from flow_scenes import make_flow_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ARGV = ["--assume_static", "--skip_exists", "--keep_intermediate", "--sample_ratio", "4",
        "--set", "track.capacity=8192"]


def _centers(rec):
    return se3.camera_center(torch.as_tensor(rec.qvec), torch.as_tensor(rec.tvec)).numpy()


def _run(mod, img, out, **kw):
    cfg = mod.config_from_args(mod.build_arg_parser().parse_args(
        ["--image_dir", str(img), "--output_dir", str(out)] + ARGV))
    return mod.run_pipeline(img, out, cfg, log=lambda *a: None, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sfm_slice")
    sc = make_flow_scene(num_views=8)
    img = root / "images"
    img.mkdir()
    rng = np.random.default_rng(0)
    for i in range(sc["num_views"]):
        Image.fromarray(rng.integers(0, 255, (sc["height"], sc["width"], 3), dtype=np.uint8)
                        ).save(img / f"{i:06d}.png")
    for name in ("jax", "torch"):
        for key, flows in sc["flows"].items():
            jflo.save_flow_dir(root / name / "optical_flows" / key, flows)
    recs = {"jax": _run(jrun, img, root / "jax"),
            "torch": _run(run, img, root / "torch", device="cpu")}
    # stage mixing: the reference's flow dirs, selfcal.json and tracks.npz
    mixed = root / "mixed"
    for sub in ("optical_flows", "trajectories"):
        shutil.copytree(root / "jax" / sub, mixed / sub)
    shutil.copy(root / "jax" / "selfcal.json", mixed / "selfcal.json")
    recs["mixed"] = _run(run, img, mixed, device="cpu")
    return root, sc, recs


def test_both_packages_register_every_frame(runs):
    _, sc, recs = runs
    for rec in recs.values():
        assert rec.num_registered == sc["num_views"]


@pytest.mark.parametrize("name", ["torch", "mixed"])
def test_poses_match_the_reference(runs, name):
    _, sc, recs = runs
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    cj = _centers(recs["jax"])
    assert alignment.ate_rmse(_centers(recs[name]), cj) <= 1e-3 * span
    assert alignment.ate_rmse(_centers(recs[name]), sc["centers"]) < 0.05 * span
    assert abs(float(recs[name].params[0]) / float(recs["jax"].params[0]) - 1) < 1e-3


@pytest.mark.parametrize("name", ["torch", "mixed"])
def test_on_disk_contracts(runs, name):
    root, sc, _ = runs
    out = root / name
    cams, images, points = cm.read_model_binary(out / "sfm" / "model")
    _, jimages, jpoints = cm.read_model_binary(root / "jax" / "sfm" / "model")
    assert sorted(im.name for im in images.values()) == sorted(im.name for im in jimages.values())
    assert abs(len(points) - len(jpoints)) <= 0.01 * len(jpoints)
    assert (out / "sfm" / "model" / "0" / "images.bin").exists()
    stats = (out / "sfm" / "stats.txt").read_text().splitlines()
    assert stats[0] == (root / "jax" / "sfm" / "stats.txt").read_text().splitlines()[0]
    conv = out / "colmap_outputs_converted"
    assert len(list((conv / "poses").glob("*.txt"))) == sc["num_views"]
    assert len(list((conv / "depths").glob("*.npy"))) == sc["num_views"]
    assert "sfm" in (out / "timings.txt").read_text()


def test_converted_poses_evaluate_like_the_reference(runs):
    """The converted 3x4 world2cam poses through the copied evaluator: the
    port's ATE against the ground truth is the reference's within 1e-3 of
    the span."""
    root, sc, _ = runs
    R = np.asarray(sc["R"], np.float64)
    t = np.asarray(sc["t"], np.float64)
    gt = {f"{i:06d}": np.concatenate([R[i], t[i][:, None]], axis=1) for i in range(len(R))}
    res = {n: evaluate_sequence(load_pose_dir(root / n / "colmap_outputs_converted" / "poses"),
                                gt, name=n) for n in ("jax", "torch")}
    span = np.linalg.norm(sc["centers"][-1] - sc["centers"][0])
    assert res["torch"].registered == res["jax"].registered == len(R)
    assert not res["torch"].failed
    assert abs(res["torch"].ate - res["jax"].ate) <= 1e-3 * span


def test_default_command_writes_the_sfm_outputs_on_cpu(tmp_path):
    """The user's default command (no --skip_sfm) with --device cpu on a
    small rendered dynamic sequence: every stage runs, and the SfM stage
    writes the reference's model files, converted outputs and stats."""
    from particlesfm_tpu_torch.synth import random_scene

    sc = random_scene(np.random.default_rng(0), num_views=6, height=64, width=96,
                      motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)
    (tmp_path / "img").mkdir()
    for i in range(6):
        Image.fromarray(sc.render(i)).save(tmp_path / "img" / f"{i:06d}.png")
    out = tmp_path / "out"
    assert run.main(["--image_dir", str(tmp_path / "img"), "--output_dir", str(out),
                     "--skip_path_consistency", "--sample_ratio", "4",
                     "--set", "track.capacity=2048", "--device", "cpu"]) == 0
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (out / "sfm" / "model" / name).exists()
    cams, images, _ = cm.read_model_binary(out / "sfm" / "model")
    assert cams[1].model == "SIMPLE_PINHOLE"
    assert (out / "sfm" / "stats.txt").read_text().startswith("Registered images: ")
    assert (out / "colmap_outputs_converted" / "poses").is_dir()
    timings = (out / "timings.txt").read_text()
    for stage in ("flow", "trajectories", "depth", "motion_seg", "sfm"):
        assert stage in timings
