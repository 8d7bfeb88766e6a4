"""Port parity, end to end: both packages' `run_pipeline` on one rendered
6-frame 64x96 sequence with the slice's configuration
(--assume_static --skip_sfm --set flow.selfcal=false, --keep_intermediate).

config.json matches byte for byte, the .flo files agree with mean |diff|
<= 1e-3 px, and the tracks.npz track counts agree within 1%.
"""
import numpy as np
import pytest
from PIL import Image

from particlesfm_tpu.pipeline import run as jrun
from particlesfm_tpu.synth import random_scene as jrandom_scene
from particlesfm_tpu_torch.io.flo import read_flo
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.synth import random_scene

T, H, W = 6, 64, 96
FLOWS = ("flow_f", "flow_b", "flow_f2", "flow_b2")


def _scene(fn):
    return fn(np.random.default_rng(0), num_views=T, height=H, width=W,
              motion_scale=0.15, rot_scale=0.2, num_static_obj=3, num_dynamic=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    sc, jsc = _scene(random_scene), _scene(jrandom_scene)
    frames = [sc.render(i) for i in range(T)]
    for i, fr in enumerate(frames):
        np.testing.assert_array_equal(fr, jsc.render(i))    # same renderer, bit for bit
    np.testing.assert_array_equal(sc.gt_flow(0, 1), jsc.gt_flow(0, 1))
    (root / "images").mkdir()
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(root / "images" / f"{i:06d}.png")
    argv = ["--image_dir", str(root / "images"), "--assume_static", "--skip_sfm",
            "--keep_intermediate", "--set", "flow.selfcal=false",
            "--set", "track.capacity=4096"]
    out = {}
    for name, mod, kw in (("jax", jrun, {}), ("torch", run, {"device": "cpu"})):
        o = root / name
        cfg = mod.config_from_args(mod.build_arg_parser().parse_args(
            argv + ["--output_dir", str(o)]))
        mod.run_pipeline(root / "images", o, cfg, log=lambda *a: None, **kw)
        out[name] = o
    return out, [sc.gt_flow(i, i + 1) for i in range(T - 1)]


def test_config_json_identical(runs):
    out, _ = runs
    assert (out["torch"] / "config.json").read_bytes() == \
        (out["jax"] / "config.json").read_bytes()


@pytest.mark.parametrize("name", FLOWS)
def test_flo_files_agree(runs, name):
    out, _ = runs
    a = [read_flo(p) for p in sorted((out["torch"] / "optical_flows" / name).glob("*.flo"))]
    b = [read_flo(p) for p in sorted((out["jax"] / "optical_flows" / name).glob("*.flo"))]
    assert len(a) == len(b) == T - (2 if name.endswith("2") else 1)
    assert np.abs(np.stack(a) - np.stack(b)).mean() <= 1e-3


def test_flow_is_accurate(runs):
    out, gt = runs
    fl = np.stack([read_flo(p) for p in sorted((out["torch"] / "optical_flows" / "flow_f")
                                               .glob("*.flo"))])
    assert np.median(np.linalg.norm(fl - np.stack(gt), axis=-1)) < 0.5


def test_tracks_agree(runs):
    out, _ = runs
    a = np.load(out["torch"] / "trajectories" / "tracks.npz")
    b = np.load(out["jax"] / "trajectories" / "tracks.npz")
    na, nb = a["xy"].shape[0], b["xy"].shape[0]
    assert nb > 500
    assert abs(na - nb) <= 0.01 * nb
    assert a["xy"].shape[1:] == (T, 2) and a["mask"].sum(1).min() >= 3
    timings = (out["torch"] / "timings.txt").read_text()
    assert "flow" in timings and "trajectories" in timings


def test_port_picks_up_reference_flow_dirs(runs, tmp_path):
    """Stage mixing: the port's tracker stage consumes the JAX run's .flo
    directories under --skip_exists instead of recomputing flow."""
    import shutil

    out, _ = runs
    shutil.copytree(out["jax"] / "optical_flows", tmp_path / "optical_flows")
    images = out["jax"].parent / "images"
    cfg = run.config_from_args(run.build_arg_parser().parse_args([
        "--image_dir", str(images), "--output_dir", str(tmp_path), "--assume_static",
        "--skip_sfm", "--skip_exists", "--keep_intermediate",
        "--set", "flow.selfcal=false", "--set", "track.capacity=4096"]))
    msgs = []
    tracks = run.run_pipeline(images, tmp_path, cfg, log=msgs.append, device="cpu")
    assert sum("reusing" in m for m in msgs) == len(FLOWS)
    assert not any("net+refine" in m for m in msgs)
    nb = np.load(out["jax"] / "trajectories" / "tracks.npz")["xy"].shape[0]
    assert abs(tracks.num_tracks - nb) <= 0.01 * nb


@pytest.mark.parametrize("mode", ["workspace_dir", "root_dir"])
def test_cli_input_modes(runs, tmp_path, mode):
    import shutil

    out, _ = runs
    seqs = ["a", "b"] if mode == "root_dir" else ["."]
    for s in seqs:
        (tmp_path / s).mkdir(exist_ok=True)
        shutil.copytree(out["jax"].parent / "images", tmp_path / s / "frames")
    target = ["--root_dir", str(tmp_path)] if mode == "root_dir" else \
        ["--workspace_dir", str(tmp_path)]
    rc = run.main(target + ["--image_folder", "frames", "--assume_static", "--skip_sfm",
                            "--set", "flow.selfcal=false", "--set", "track.capacity=4096",
                            "--sample_ratio", "4", "--device", "cpu"])
    assert rc == 0
    for s in seqs:
        res = tmp_path / s / "particlesfm_tpu"
        assert np.load(res / "trajectories" / "tracks.npz")["xy"].shape[0] > 50
        assert not (res / "optical_flows").exists()      # intermediates removed


def test_cli_without_inputs_returns_2(capsys):
    assert run.main(["--assume_static"]) == 2
    assert "need --image_dir" in capsys.readouterr().err
