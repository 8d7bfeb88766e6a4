"""Port parity: host-side modules copied or re-written for the port
(config tree and overrides, .flo files, image loading, stage timer)."""
import json

import numpy as np
import pytest
from PIL import Image

from particlesfm_tpu.io import flo as jflo
from particlesfm_tpu.io.images import load_image_stack as jload_image_stack
from particlesfm_tpu.pipeline import run as jrun
from particlesfm_tpu.utils import config as jconfig
from particlesfm_tpu.utils.profiling import StageTimer as JStageTimer
from particlesfm_tpu_torch.io import flo, images
from particlesfm_tpu_torch.pipeline import run
from particlesfm_tpu_torch.utils import config
from particlesfm_tpu_torch.utils.profiling import StageTimer

ARGV = [
    ["--image_dir", "x", "--output_dir", "y"],
    ["--image_dir", "x", "--output_dir", "y", "--assume_static", "--skip_sfm",
     "--sample_ratio", "3", "--set", "flow.selfcal=false", "--set", "track.capacity=4096",
     "--set", "flow.refine_schedule=[[1,2.0,3]]", "--set", "sfm.ba.loss=cauchy",
     "--set", "flow.iters=12", "--set", "flow.infer_scale=1"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_config_json_and_overrides_match(tmp_path, argv):
    jcfg = jrun.config_from_args(jrun.build_arg_parser().parse_args(argv))
    tcfg = run.config_from_args(run.build_arg_parser().parse_args(argv))
    jconfig.save_config(jcfg, tmp_path / "j.json")
    config.save_config(tcfg, tmp_path / "t.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    back = config.load_config(tmp_path / "j.json")
    assert json.loads(json.dumps(config._to_dict(back))) == json.loads(
        (tmp_path / "j.json").read_text())


def test_flo_files_interchange(tmp_path):
    f = np.random.default_rng(0).normal(0, 4, (9, 13, 2)).astype(np.float32)
    flo.write_flo(tmp_path / "t.flo", f)
    jflo.write_flo(tmp_path / "j.flo", f)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(jflo.read_flo(tmp_path / "t.flo"), f)
    np.testing.assert_array_equal(flo.read_flo(tmp_path / "j.flo"), f)


def test_image_stack_ppm_and_png_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 7, 11, 3), dtype=np.uint8)
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(tmp_path / f"{i:06d}.ppm")
    stack, names = images.load_image_stack(tmp_path)
    jstack, jnames = jload_image_stack(tmp_path)
    assert names == jnames and stack.dtype == np.float32
    np.testing.assert_array_equal(stack, jstack)
    np.testing.assert_array_equal(stack, frames.astype(np.float32))
    Image.fromarray(frames[0]).save(tmp_path / "000000.png")
    (tmp_path / "000000.ppm").unlink()
    stack, _ = images.load_image_stack(tmp_path)
    np.testing.assert_array_equal(stack, jload_image_stack(tmp_path)[0])


def test_image_stack_modes_and_listing_match_reference(tmp_path):
    """Grey and RGBA frames come back as RGB, other files are skipped, and an
    empty directory raises, as in the reference loader."""
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (5, 6), dtype=np.uint8)).save(tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)).save(tmp_path / "b.png")
    (tmp_path / "notes.txt").write_text("not an image")
    stack, names = images.load_image_stack(tmp_path)
    jstack, jnames = jload_image_stack(tmp_path)
    assert names == jnames == ["a.png", "b.png"] and stack.shape == (2, 5, 6, 3)
    np.testing.assert_array_equal(stack, jstack)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        images.load_image_stack(empty)


def test_stage_timer_report_matches_reference():
    t, j = StageTimer(), JStageTimer()
    for timer in (t, j):
        timer.totals.update(flow=12.5, trajectories=3.25, frame_upload=0.125)
        timer.counts.update(flow=1, trajectories=1, frame_upload=2)
    assert t.report() == j.report()
